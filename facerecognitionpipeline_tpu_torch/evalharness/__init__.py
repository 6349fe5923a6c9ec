"""Evaluation harness of the port (so far only the stress-scene renderer that
the detector's int8 calibration needs; the metrics are queued in
ROADMAP.md)."""
