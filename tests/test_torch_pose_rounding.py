"""Queue 3.1 of the port: MC pose steps across chunks held to JAX.

Both packages key the stream route's MC noise on the sorted row (the
binned route's on the bin-local slot), so an ulp of posed vertex
coordinate can swap near-equal sort keys and with them the noise.  The
port rounds the pose path's 3-term products as XLA does at optimisation
level 0 (``transforms.matmul3``, ``cross3``) and takes its sqrt / sin /
cos correctly rounded through float64; the JAX side is compiled at level
0 (``_torch_parity.jax_exact``).  Here: posed NDC coordinates equal
JAX's bit for bit; the focal length's tangent and the vertex normals'
roots, which the port takes correctly rounded on every machine (as XLA
folds a closed-over camera's tangent at compile time, and as its sqrt
rounds); the one op that still parts the packages (XLA's C
library ``sinf`` / ``cosf``); three multi-chunk GaussianRast +
GaussianAgg pose steps on the icosphere (1280 faces, 20 chunks) held to
JAX; and where a free-running run of them parts from JAX's, and why.
The pose-step helpers are test_torch_stream_train.py's (one JAX
trajectory per scene, shared by the two step tests)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu_torch import convert

from _torch_parity import one_torch_thread  # noqa: F401
from test_torch_stream_train import (_close, _env,  # noqa: F401
                                     _pose_steps, _pose_steps_match_jax)


def test_stream_gaussian_pose_steps_match_jax_on_the_icosphere():
    """The GaussianRast + GaussianAgg pair over three multi-chunk steps of
    the icosphere (1280 faces, 20 chunks).  Both packages key the MC noise
    on the sorted row, so the posed vertices must agree to the bit: the
    port rounds the pose path's 3-term products as XLA does at level 0
    (``transforms.matmul3``), and the JAX step is compiled at level 0.
    Each step starts from JAX's pose: the two packages' MC gradients sum
    in other orders (1e-7 apart), Adam's first update g / |g| then rounds
    an ulp apart, and an ulp of pose reorders the sort keys and with them
    the noise of the next step (loss 2.3e-4 apart at the third step when
    the port runs on from its own pose)."""
    _pose_steps_match_jax("gaussian", 32, 1280, anchor=True, k=50, s=2,
                          mesh_kind="icosphere")


def test_free_running_gaussian_steps_part_from_jax_only_by_ulps_of_pose():
    """The icosphere's gaussian steps of the test above, each package from
    its own pose.  Where the run parts and why: at every step the port's
    loss at JAX's pose equals JAX's (rtol 1e-5), the two poses lie within
    1e-6 of each other (the step tests' log_rot tolerance; a few ulps),
    and a step that starts from the same pose bits gives JAX's loss and
    pose gradient (1e-3 of its max).  The poses part at an Adam update:
    the two packages' MC pose gradients, summed in other orders, agree to
    1e-3 of their max but not to the bit, so the first update leaves the
    poses an ulp (3e-8) apart and the second 3.9e-7; that much pose can
    reorder near-equal sort keys and with them the noise rows, and the
    third step's loss lies 2.3e-4 off JAX's while the port's loss at
    JAX's pose lies 7e-8 off it."""
    *steps, _last = _pose_steps("gaussian", 32, 1280, probe=True, k=50,
                                s=2, mesh_kind="icosphere")
    for st in steps:
        np.testing.assert_allclose(st["at_jax_pose"], st["loss"], rtol=1e-5)
        np.testing.assert_allclose(st["port_in"], st["jax_in"], rtol=0,
                                   atol=1e-6)
        if np.array_equal(st["port_in"], st["jax_in"]):
            np.testing.assert_allclose(st["out"].loss.item(), st["loss"],
                                       rtol=1e-5)
            _close(st["out"].g_pose.numpy(), st["g_pose"], 1e-3)
    assert np.array_equal(steps[0]["port_in"], steps[0]["jax_in"])


def test_posed_ndc_coordinates_equal_jax_bit_for_bit():
    """Rotate and the camera's world -> NDC transform of the port equal the
    JAX package's under ``jax_exact`` bit for bit on the icosphere at a few
    poses (the sort keys of the stream and binned routes are made of these
    coordinates), as do the camera centre and ``look_at_rotation``."""
    import pertrenderer_tpu as jpt
    from _torch_parity import jax_exact, scene_mesh

    verts = np.asarray(scene_mesh("icosphere").verts)
    r, t = jpt.look_at_view_transform(dist=6.7, elev=30.0, azim=120.0)
    jcams = jpt.PerspectiveCameras.create(R=r, T=t, fov=60.0)
    tcams = convert.from_reference(jcams, device="cpu")
    for seed in range(3):
        rot = np.array(jpt.so3_exp_map(jnp.asarray(np.random.default_rng(
            seed).normal(scale=0.4, size=(1, 3)).astype(np.float32))))
        want = np.asarray(jax_exact(
            lambda m, v: jcams.transform_points_ndc(
                jpt.Rotate(m).transform_points(v)),
            jnp.asarray(rot), jnp.asarray(verts)))
        got = tcams.transform_points_ndc(ptt.Rotate(torch.from_numpy(
            rot)).transform_points(torch.from_numpy(verts.copy())))
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tcams.camera_center().numpy(),
        np.asarray(jax_exact(lambda m, v: jpt.PerspectiveCameras.create(
            R=m, T=v).camera_center(), r, t)))
    pos = np.random.default_rng(4).normal(size=(16, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        ptt.cameras.look_at_rotation(torch.from_numpy(pos),
                                     device="cpu").numpy(),
        np.asarray(jax_exact(jpt.look_at_rotation, jnp.asarray(pos))))


@pytest.mark.parametrize("part", ["focal", "normals"])
def test_focal_tangent_and_normal_roots_are_correctly_rounded(part):
    """The two ops whose float32 library versions parted the NDC and
    vertex-normal parity tests on some x86 machines, bit for bit on every
    machine.  ``focal``: s = 1 / tan(fov / 2) of the port equals 1 / the
    correctly rounded tangent at twelve field-of-view angles, and equals
    the JAX package's, whose camera the tests close over, so that XLA
    folds the tangent at compile time, correctly rounded (float32 library
    tangents, the C library's and torch's, miss it in the last place for a
    few percent of angles, fov 60 among them).  ``normals``: the port's
    vertex normals divide by sqrt((x^2 + y^2) + z^2) correctly rounded,
    as XLA's sqrt rounds (torch's float32 CPU sqrt misses it for a fifth
    of inputs on some machines), and equal JAX's bit for bit."""
    import pertrenderer_tpu as jpt
    from _torch_parity import jax_exact, scene_mesh

    if part == "focal":
        fovs = np.array([20.0, 25.0, 30.0, 37.5, 45.0, 50.0, 55.0, 60.0,
                         75.0, 90.0, 110.0, 120.0], dtype=np.float32)
        pts = np.ones((1, 1, 3), dtype=np.float32)
        for fov in fovs:
            half = np.float32(0.5) * (fov * np.float32(np.pi / 180.0))
            want = np.float32(1.0) / np.float32(np.tan(np.float64(half)))
            tcams = ptt.PerspectiveCameras.create(fov=float(fov),
                                                  device="cpu")
            got = tcams.project_view_to_ndc(torch.from_numpy(pts))
            jcams = jpt.PerspectiveCameras.create(fov=float(fov))
            jgot = np.asarray(jax_exact(jcams.project_view_to_ndc,
                                        jnp.asarray(pts)))
            assert got[0, 0, 1].item() == want, fov
            np.testing.assert_array_equal(got.numpy(), jgot)
        return
    from pertrenderer_tpu_torch import structures

    mesh = scene_mesh("icosphere")
    tmesh = convert.from_reference(mesh, device="cpu")
    vn = tmesh.verts_normals().numpy()
    fn = tmesh.face_normals(normalize=False)
    un = torch.zeros(tmesh.max_verts, 3).index_add_(
        0, tmesh.faces[0, :, 0], fn[0]).index_add_(
        0, tmesh.faces[0, :, 1], fn[0]).index_add_(
        0, tmesh.faces[0, :, 2], fn[0]).numpy()
    sq = un * un
    root = np.sqrt((sq[:, 0] + sq[:, 1]) + sq[:, 2])      # IEEE: rounded
    np.testing.assert_array_equal(
        structures._norm(torch.from_numpy(un)).numpy()[:, 0], root)
    np.testing.assert_array_equal(
        vn, np.asarray(jax_exact(lambda m: m.verts_normals(), mesh)))


def test_so3_exp_map_parts_from_jax_only_where_xla_sin_cos_round_off():
    """The one op of the pose path that still parts the two packages:
    ``sin`` / ``cos`` of the rotation angle.  The port takes them (and the
    angle's sqrt) correctly rounded, through float64, on every device; XLA
    on the CPU calls the C library's float ``sinf`` / ``cosf``, which miss
    the correctly rounded value in the last place for ~1% of angles.  Over
    400 poses so3_exp_map equals JAX's bit for bit exactly where XLA's sin
    and cos of the angle are correctly rounded, and differs at least once
    where they are not."""
    import pertrenderer_tpu as jpt
    from _torch_parity import jax_exact

    rng = np.random.default_rng(0)
    log_rot = rng.normal(scale=0.4, size=(400, 3)).astype(np.float32)
    want = np.asarray(jax_exact(jpt.so3_exp_map, jnp.asarray(log_rot)))
    got = ptt.so3_exp_map(torch.from_numpy(log_rot)).numpy()
    theta = np.sqrt(np.maximum(np.sum(log_rot * log_rot, axis=1),
                               np.float32(1e-16)).astype(np.float64))
    theta = theta.astype(np.float32)
    xla = [np.asarray(jax_exact(f, jnp.asarray(theta)))
           for f in (jnp.sin, jnp.cos)]
    exact = [f(theta.astype(np.float64)).astype(np.float32)
             for f in (np.sin, np.cos)]
    rounded = (xla[0] == exact[0]) & (xla[1] == exact[1])
    same = np.all(got == want, axis=(1, 2))
    assert rounded.sum() > 350
    np.testing.assert_array_equal(same[rounded], True)
    assert not same[~rounded].all()
