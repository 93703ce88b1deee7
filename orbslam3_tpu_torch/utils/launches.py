"""Launch counts of the hand-written kernels.

Each kernel's wrapper holds a plain integer, `wrapper.launches`, and adds
one to it where it launches its kernel.  This registry reads them all
(`snapshot`), adds to them (`add`) and sets them to 0 (`reset`).  The
replay of a CUDA graph runs no Python, so `utils.frame_graph.FrameGraph`
records what a capture added (`recorded`), takes it back, since the
capture launched nothing on the card, and adds it again at every replay.
"""

from __future__ import annotations

import contextlib


def _wrappers() -> dict:
    """The counted wrapper of each hand-written kernel, by kernel name."""
    from orbslam3_tpu_torch.frontend.stereo_frame import sad_refine, stereo_pairs
    from orbslam3_tpu_torch.ops import fast_variants as fv
    from orbslam3_tpu_torch.ops.brief import brief_descriptors
    from orbslam3_tpu_torch.ops.fast import detect_fused, raw_score_map
    from orbslam3_tpu_torch.ops.select import candidate_pools
    from orbslam3_tpu_torch.ops.window_gather import gather_windows, sample_windows, window_moments
    from orbslam3_tpu_torch.vocab.device_vocabulary import vocab_descend

    return {
        "fast_score": raw_score_map, "gather_windows": gather_windows,
        "detect_fused": detect_fused, "window_moments": window_moments,
        "sample_windows": sample_windows, "brief_descriptors": brief_descriptors,
        "fast_variant_t1": fv.fast_variant_t1, "fast_variant_t2": fv.fast_variant_t2,
        "fast_variant_t3": fv.fast_variant_t3, "fast_variant_t4": fv.fast_variant_t4,
        "grid_pool": candidate_pools, "stereo_hamming": stereo_pairs, "sad_refine": sad_refine,
        "vocab_descend": vocab_descend,
    }


def snapshot() -> dict[str, int]:
    """Launch counts of the hand-written kernels in this process (one per
    wrapper call that launched its kernel, and one per launch replayed)."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def add(deltas: dict[str, int]) -> None:
    """Add `deltas[name]` to the count of each kernel named there."""
    fns = _wrappers()
    for name, n in deltas.items():
        fns[name].launches += n


def reset() -> None:
    """Set every count to 0."""
    for fn in _wrappers().values():
        fn.launches = 0


@contextlib.contextmanager
def recorded():
    """Yields a dict that, when the block ends (or raises), holds what the
    block added to each count; the counts are then set back to their
    values before the block."""
    before = snapshot()
    added: dict[str, int] = {}
    try:
        yield added
    finally:
        after = snapshot()
        added.update({k: after[k] - before[k] for k in after if after[k] != before[k]})
        add({k: -n for k, n in added.items()})
