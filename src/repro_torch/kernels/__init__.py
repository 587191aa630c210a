"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version (see ``_build`` for how they are compiled and loaded).

Each wrapper counts its kernel's launches in ``fn.launches`` through
``count_launches``: replicas' threads launch kernels and replay graphs side
by side, so an update takes a lock.

A wrapper runs its plain version for a tensor on the CPU (the tests) or on
the meta device (the dry run, which propagates shapes and computes
nothing), launches its kernel for a CUDA tensor, and raises for any other
device (``runs_plain``): nothing falls back from the card to the CPU."""
import threading

_COUNT_LOCK = threading.Lock()


def count_launches(fn, n: int = 1) -> None:
    """Add ``n`` to kernel wrapper ``fn``'s ``launches`` count."""
    with _COUNT_LOCK:
        fn.launches += n


PLAIN_DEVICES = ("cpu", "meta")


def runs_plain(t) -> bool:
    """Whether a wrapper given tensor ``t`` runs its plain version (``t`` on
    the CPU or the meta device) rather than its kernel (``t`` on the card);
    any other device raises."""
    kind = t.device.type
    if kind in PLAIN_DEVICES:
        return True
    if kind != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False
