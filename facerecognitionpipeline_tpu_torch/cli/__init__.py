"""Command-line entry points of the port: the recognition server, the camera
client and the live single-process app; enrolment, matching, batch detection
and camera capture; the offline dataset chain (dataset_preprocessor,
segment_dataset, probe_labeler, embedding_generator, evaluate_models) and its
helpers (label_rename_utility, lfw_impostor_helper)."""
