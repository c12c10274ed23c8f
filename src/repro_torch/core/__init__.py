"""Plain PyTorch numerics of the biosignal application and the shuffle
unit.

  fir       — causal FIR and the low-pass taps
  fft       — radix-2 Stockham FFT and the packed real FFT
  biosignal — the MBioTracker application (preprocess/delineate/features/SVM)
  shuffle   — the VWR2A shuffle unit's four permutations
"""
