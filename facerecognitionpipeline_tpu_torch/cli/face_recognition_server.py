"""face_recognition_server CLI — thin wrapper over serve.server.main."""

from facerecognitionpipeline_tpu_torch.serve.server import main

if __name__ == "__main__":
    raise SystemExit(main())
