"""face_detection (camera capture) CLI — thin wrapper over serve.capture.main."""

from facerecognitionpipeline_tpu_torch.serve.capture import main

if __name__ == "__main__":
    raise SystemExit(main())
