"""The plain reference that decides `correct`: float32 PyTorch, TF32 off,
importing nothing of the program and nothing of JAX."""
