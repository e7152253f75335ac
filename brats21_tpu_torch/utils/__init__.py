"""Weight carry-over from the JAX package and reference ``.pth`` files."""
