"""The PyTorch and CUDA port's benchmark (``python3 cardbench/run.py``)."""
