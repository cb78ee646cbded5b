"""K1, the hash-PRNG probe of the PyTorch port, against the committed
goldens (tests/goldens/prng_goldens.npz, recorded from the JAX package).

The uniform stage is integer hashing plus a power-of-two scale: bit-exact.
Gaussian and cauchy go through transcendentals, held to the tolerances of
the JAX package's own pin (bench.py): 5e-4 absolute, 1e-5 relative."""

import numpy as np
import pytest
import torch

from pertrenderer_tpu_torch.ops import fused_render as tfr

from test_torch_cuda import GOLDENS, check_against_goldens


@pytest.mark.parametrize("noise_type", ["uniform", "gaussian", "cauchy"])
def test_prng_probe_plain_matches_goldens(noise_type):
    ref = np.load(GOLDENS)[noise_type]
    got = tfr.prng_probe_plain(noise_type, device="cpu").numpy()
    assert got.shape == ref.shape == (4, 16, 256)
    check_against_goldens(noise_type, got, ref)


def test_prng_probe_wrapper_takes_plain_on_cpu():
    before = dict(tfr.launch_counts)
    got = tfr.prng_probe("gaussian", s=2, c=8, p=64, device="cpu")
    want = tfr.prng_probe_plain("gaussian", s=2, c=8, p=64, device="cpu")
    assert torch.equal(got, want)
    assert tfr.launch_counts == before          # no kernel launch on CPU


def test_box_muller_row_pairing():
    """Row r < c/2 is the cos half of hash(r); row r + c/2 its sin half —
    so the first half of a 16-row block is NOT the 8-row block."""
    b16 = tfr.prng_probe_plain("gaussian", s=1, c=16, p=32, device="cpu")[0]
    b8 = tfr.prng_probe_plain("gaussian", s=1, c=8, p=32, device="cpu")[0]
    assert torch.equal(b16[:4], b8[:4])         # cos halves of rows 0..3
    assert not torch.equal(b16[4:8], b8[4:8])   # sin halves vs cos halves
