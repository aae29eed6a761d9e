"""The plain reference: PyTorch in float32, independent of the program
(it imports nothing of ``repro_torch`` and reads only the weights and
inputs the benchmark made)."""
