from deepfilternet_torch.utils.audio_io import load_audio, resample, save_audio  # noqa: F401
