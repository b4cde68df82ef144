"""Progress reporting for long host-side loops (a copy of
``rfi_toolbox_tpu/utils/progress.py``).

The reference tqdm-wraps its per-baseline MS loops and generation
batches (reference ms_loader.py:199,468,513; synthetic_generator.py:
321,334) — hours of wall-clock on a real observation would otherwise be
silent. This helper applies tqdm when it is importable and stderr is a
terminal (so tests/pipelines stay clean), and degrades to the plain
iterable otherwise.
"""

import sys

__all__ = ["progress"]


def progress(iterable, desc=None, total=None, enabled=None):
    """Wrap ``iterable`` in a tqdm bar.

    Args:
        enabled: True/False forces the bar on/off; None (default)
            enables it only when stderr is a tty.
    """
    if enabled is None:
        try:
            enabled = sys.stderr.isatty()
        except Exception:
            enabled = False
    if not enabled:
        return iterable
    try:
        from tqdm import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, desc=desc, total=total)
