"""The plain reference: DeepJ in float32 PyTorch and the random streams it
works out again.  Imports nothing of the program."""
