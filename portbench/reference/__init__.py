"""The benchmark's plain reference: NumPy and plain PyTorch float32 with TF32
off, importing nothing of the program it judges. It is handed the same raw
inputs and weights as the program and works out everything else again."""
