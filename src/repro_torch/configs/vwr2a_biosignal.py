"""The paper's own workload: MBioTracker biosignal application configuration
(VWR2A, DAC'22 §4.4). Consumed by core/biosignal.py and the stream runtime."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class BiosignalConfig:
    name: str = "vwr2a-biosignal"
    sample_rate_hz: int = 64
    window_samples: int = 2048       # processing window
    fir_taps: int = 11               # paper: 11-tap FIR preprocess
    fft_size: int = 512              # paper: real-valued 512-point FFT features
    svm_features: int = 12           # time + frequency features
    svm_classes: int = 2             # cognitive workload binary estimate
    fixed_point: str = "q16.15"      # VWR2A single-cycle fixed-point format


CONFIG = BiosignalConfig()
