"""Evaluation harness of the port (counterpart of
`facerecognitionpipeline_tpu/evalharness`): identification, verification,
impostor and segmented metrics scored on the device (`metrics`,
`identification`, `verification`), comparisons and statistics
(`comparison`), hardened variants (`hardening`), the pipeline with its
exports (`pipeline`) and the detector stress suite (`detection`). The
package re-exports nothing, so importing `evalharness.detection` (the int8
calibration's scenes) pulls in neither pandas nor scipy."""
