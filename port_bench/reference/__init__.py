"""The benchmark's plain reference: the WaveFormer forward, the Gaussian
sliding window with mirror TTA, DiceCE and optax-form clip + AdamW, in
plain PyTorch. It imports nothing of the system under test, nor JAX."""
