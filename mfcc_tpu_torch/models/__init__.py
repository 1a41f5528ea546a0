from .features import (  # noqa: F401
    Spectrogram, MelSpectrogram, LogMelSpectrogram, MFCCFeatures,
    IntMFCCFeatures, LibrosaMFCC, wav2mfcc_model, mic2mfcc_model,
)
