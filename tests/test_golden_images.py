"""Golden-image snapshots: one fixed-seed camera frame per family/texture,
checked against an npz of SHA-pinned frames in tests/data/golden_frames.npz.

Complements the oracle parity tests with a defense they can't provide: the
oracles are re-derived implementations, so a palette constant or layout
convention changed *everywhere at once* would slip through backend-vs-oracle
comparison.  The snapshots pin the actual bytes.

Regenerate deliberately after an intended visual change:
    python -m tests.test_golden_images --regen
"""

import os

import jax
import numpy as np
import pytest

from raycastworlds_tpu.oracle import parity

_DATA = parity.GOLDEN_PATH


@pytest.mark.parametrize("name", sorted(parity.golden_games().keys()))
def test_golden_frame(name):
    if not os.path.exists(_DATA):
        pytest.skip("golden_frames.npz not generated")
    with np.load(_DATA) as golden:
        assert name in golden.files, f"{name} missing from golden set — regen"
    parity.golden(name).assert_exact()


if __name__ == "__main__":
    import sys

    # Snapshots are CPU-defined (the parity reference platform); force it
    # before any tracing so a regen never runs on an accelerator.
    jax.config.update("jax_platforms", "cpu")

    if "--regen" in sys.argv:
        os.makedirs(os.path.dirname(_DATA), exist_ok=True)
        frames = {
            k: parity.golden_frame(g) for k, g in parity.golden_games().items()
        }
        np.savez_compressed(_DATA, **frames)
        for k, v in frames.items():
            print(f"{k}: {v.shape} {v.dtype} sum={int(np.sum(v, dtype=np.uint64))}")
        print(f"wrote {_DATA}")
