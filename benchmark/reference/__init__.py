"""The plain reference of the benchmark's models, in plain PyTorch and
NumPy: it imports neither JAX nor anything of the program, and takes only
the inputs the benchmark makes (weights, poses, draws), from which it works
out everything else again."""
