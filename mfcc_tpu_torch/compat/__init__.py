from . import librosa_mfcc  # noqa: F401
