"""face_recognition_live CLI — thin wrapper over serve.live.main."""

from facerecognitionpipeline_tpu_torch.serve.live import main

if __name__ == "__main__":
    raise SystemExit(main())
