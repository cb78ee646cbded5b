"""Three binned pose steps of both packages (the gaussian pair, whose
noise keys on the bin-local slot) on test_torch_binned.py's route:
test_torch_stream_train.py's step helper and tolerances."""

from _torch_parity import one_torch_thread  # noqa: F401
from test_torch_binned_tables import IMAGE, _env  # noqa: F401
from test_torch_stream_train import _pose_steps_match_jax


def test_binned_pose_steps_match_jax():
    """Three binned pose steps of both packages (the gaussian pair, whose
    noise keys on the bin-local slot, S=2; JAX's step at XLA level 0),
    each from JAX's pose (a free-running run parts at an ulp of pose, as
    test_torch_pose_rounding.py shows on the stream route): losses rtol
    1e-5, gradients 1e-3 of max, log_rot atol 1e-6
    (test_torch_stream_train.py's helper)."""
    _pose_steps_match_jax("gaussian", IMAGE, None, anchor=True,
                          route="binned", k=50, s=2, mesh_kind="icosphere",
                          settings=dict(bin_overflow="allow",
                                        max_faces_per_bin=32))
