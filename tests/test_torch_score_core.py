"""The algebra of the FAST score core that B1 and B3 run on the card.

``csrc/fast_score.cuh`` does not form the 16 ring differences.  It reduces
the raw u8 ring values, per pixel, to A = the max over the 16 circular
9-arcs of the arc's min and B = the min over the arcs of the arc's max
(min over an arc of ring - c is that arc's min of ring, minus c), each
with a van Herk window over two blocks of 8, and folds
score = max(A - c, c - B) - 1 as max(A + 255 - c, c + 255 - B) - 256 in
unsigned 16-bit lanes.  `folded_score` below is that arithmetic in plain
torch; it must equal the port's `raw_score_map_plain` and the JAX
package's `raw_score_map` (XLA form) and `_raw_score_pallas` (interpret
mode), with the mask and without, on images that reach both ends of the
score's range (tools/score_extremes.py).  test_torch_fused.py holds the
B3 twin against the JAX fused kernel at the thresholds of that module;
the `cuda` tests of test_torch_fast.py and test_torch_fused.py run the
kernels on the same inputs where a card is present.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orbslam3_tpu.ops import fast as jf
from orbslam3_tpu_torch.oracle.orb_cpu import FAST_RING
from orbslam3_tpu_torch.ops import fast as tf
from orbslam3_tpu_torch.tools import score_extremes as se


def _block8_window(p, op):
    """Circular window-9 `op` over the 16 planes p (list), van Herk with
    two blocks of 8: window o < 8 is suffix o of block 0 with prefix o of
    block 1, window 8 + o is suffix o of block 1 with prefix o of block 0."""
    def scans(b):
        pf = [b[0]]
        for k in range(1, 8):
            pf.append(op(pf[-1], b[k]))
        sf = [None] * 8
        sf[7] = b[7]
        for k in range(6, 0, -1):
            sf[k] = op(sf[k + 1], b[k])
        sf[0] = pf[7]  # the whole block, shared
        return pf, sf

    pf0, sf0 = scans(p[:8])
    pf1, sf1 = scans(p[8:])
    return [op(sf0[o], pf1[o]) for o in range(8)] + [op(sf1[o], pf0[o]) for o in range(8)]


def folded_score(img: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's arithmetic in plain torch: (h, w) int32, zero outside
    the 3-px frame or outside `mask`."""
    h, w = img.shape
    c = img.to(torch.int32)
    pad = torch.nn.functional.pad(c, (3, 3, 3, 3))
    ring = [pad[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] for dx, dy in FAST_RING.tolist()]
    a = torch.stack(_block8_window(ring, torch.minimum)).amax(0)  # max over arcs of the min
    b = torch.stack(_block8_window(ring, torch.maximum)).amin(0)  # min over arcs of the max
    biased = torch.maximum(a + 255 - c, c + 255 - b)
    assert int(biased.min()) >= 0 and int(biased.max()) <= 510  # fits an unsigned 16-bit lane
    score = biased - 256
    if mask is None:
        mask = torch.zeros((h, w), dtype=torch.bool)
        mask[3 : h - 3, 3 : w - 3] = True
    return torch.where(mask, score, 0)


IMAGES = se.score_images()


@pytest.mark.parametrize("name", sorted(IMAGES))
@pytest.mark.parametrize("masked", [False, True])
def test_folded_score_equals_plain_and_jax(name, masked):
    img = IMAGES[name]
    mask = se.seam_mask(*img.shape) if masked else None
    t_mask = None if mask is None else torch.from_numpy(mask)
    got = folded_score(torch.from_numpy(img), t_mask)
    np.testing.assert_array_equal(got.numpy(), tf.raw_score_map_plain(torch.from_numpy(img), t_mask).numpy())
    want = np.asarray(jf._raw_score_pallas(jnp.asarray(img), interpret=True, mask_np=mask))
    np.testing.assert_array_equal(got.numpy(), want)
    if mask is None:
        np.testing.assert_array_equal(got.numpy(), np.asarray(jf.raw_score_map(jnp.asarray(img))))


def test_score_reaches_both_ends_of_its_range():
    """254 for a lone spot (differences of +-255), -128 at the centre of
    the alternating ring: the int16 scratch of B3 must hold both."""
    for name in ("bright_spots", "dark_spots"):
        score = folded_score(torch.from_numpy(IMAGES[name]))
        assert int(score.max()) == 254, name
    ring = folded_score(torch.from_numpy(IMAGES["alternating_ring"]))
    assert int(ring.min()) == -128
    assert int(folded_score(torch.from_numpy(IMAGES["flat255"])).min()) == -1


def test_extreme_checks_run_on_cpu():
    """The smoke's extreme cases (tools/bench_score_kernels.py) on CPU
    tensors, where the wrappers take their plain versions: every case
    present and exact."""
    from orbslam3_tpu_torch.tools import bench_score_kernels as bsk

    b1 = bsk.b1_extreme_errs(torch.device("cpu"))
    assert len(b1) == 2 * len(IMAGES) and not any(b1.values())
    comp, mask = se.b3_case("random", seed=5, h=96, w=128)
    b3 = bsk.b3_extreme_errs(torch.device("cpu"), {"random": (torch.from_numpy(comp),
                                                               torch.from_numpy(mask))})
    assert len(b3) == len(se.B3_THRESHOLDS) + 3 and not any(b3.values())
