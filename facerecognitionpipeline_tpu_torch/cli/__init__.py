"""Command-line entry points of the port: the recognition server, the camera
client and the live single-process app; enrolment, matching, batch detection
and camera capture."""
