"""Training-side code of the port (so far only the synthetic renderers that
the int8 calibration needs; the trainers are queued in ROADMAP.md)."""
