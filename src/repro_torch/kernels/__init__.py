"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version (see ``_build`` for how they are compiled and loaded).

Each wrapper counts its kernel's launches in ``fn.launches`` through
``count_launches``: replicas' threads launch kernels and replay graphs side
by side, so an update takes a lock."""
import threading

_COUNT_LOCK = threading.Lock()


def count_launches(fn, n: int = 1) -> None:
    """Add ``n`` to kernel wrapper ``fn``'s ``launches`` count."""
    with _COUNT_LOCK:
        fn.launches += n
