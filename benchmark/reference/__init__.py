"""The benchmark's plain reference: NumPy, SciPy and plain PyTorch, with no
import of the program under test or of JAX. ``nets`` holds the networks,
``serve`` the served path, ``train`` the training step, ``fp8`` the
control's lower precision."""
