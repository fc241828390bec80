"""The benchmark's plain reference: the configurations' models, the three
kernels' plain versions and Adam, in plain PyTorch. It imports nothing of
the program under test."""
