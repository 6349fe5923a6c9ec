"""face_recognition_client CLI — thin wrapper over serve.client.main."""

from facerecognitionpipeline_tpu_torch.serve.client import main

if __name__ == "__main__":
    raise SystemExit(main())
