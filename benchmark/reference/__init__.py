"""The benchmark's plain reference: frozen copies of the program's plain
PyTorch and NumPy modules (each file names what it was copied from and the
commit), a float64 AGC and a float64 batched VQT. It imports nothing of
``pitchvis_tpu_torch`` and takes nothing that the program made."""
