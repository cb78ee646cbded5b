"""The port's scene-parameter loop against the JAX package's
``optimize_scene_params``.

Three steps on the cube x2 at 16^2, two views (elev 25 / 35, azim 110 /
200), GaussianRast + GaussianAgg at S=4, with the vertex colours (from
white), the light location and the per-view cameras trainable, the
cameras in their own Adam group at 20x the learning rate (``lr_scales``),
the vertex offsets frozen.  JAX runs ``optimize_scene_params`` once for
the module, for one segment of ``segment_size=3`` (the run of
``Niter=3``) of a schedule of ``Niter=4`` with ``adapt_reg`` and
``anneal_start=1``, stopped by ``max_segments=1``: boundary 3 anneals
(sigma / 1.1, gamma / 1.5, the blur from sigma, S 4 -> 8, lr / 1.5, a
new optimizer) and is checkpointed, and no second program is compiled.
An optimizer wrapper records the gradients it is fed (after the
finiteness guard) and the parameters before each update; the checkpoint
is kept in memory.  The port's ``scene_step`` is fed JAX's
seed words of each step's key (``key, sub = split(key)``, then the
render's split into coverage and aggregation keys).

Tolerances: losses rtol 1e-5; gradients (MC: shared noise, ulp-level
threshold flips) within 1e-3 of their max |grad|; parameters after each
step within 1e-6 times their learning-rate scale (an Adam step is
lr-sized, so gradients that part in the last places move a camera angle
at 20x the rate 20x as far), or one float32 ulp of their value where that
is larger.  Then the port's optimize_scene_params on the same schedule,
fed JAX's seed words: its losses and its checkpoint at boundary 3
against JAX's.  Plus the
port's loop killed after two segments and resumed from its checkpoint:
bit-equal to the uninterrupted run on the CPU, across two annealing
boundaries."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pertrenderer_tpu.experiments import harness as jh
from pertrenderer_tpu.ops import fused_render as jfr
from pertrenderer_tpu.utils import checkpoint as jckpt
from pertrenderer_tpu_torch import convert
from pertrenderer_tpu_torch.experiments import harness as th
from pertrenderer_tpu_torch.utils import checkpoint

from _torch_parity import build, interpret_env, one_torch_thread  # noqa: F401

LR, STEPS, SEED = 5e-2, 3, 13
# One segment of three steps, then boundary 3's annealing and checkpoint.
SCHEDULE = dict(lr_init=LR, Niter=STEPS + 1, segment_size=STEPS,
                adapt_reg=True, anneal_start=1, max_segments=1)
ELEV, AZIM = [25.0, 35.0], [110.0, 200.0]
LIGHT = [[0.5, 3.0, -2.0]]
PARAMS = {"camera": True, "textures": True, "vertices": False,
          "light": True}
LR_SCALES = {"camera_elev": 20.0, "camera_azim": 20.0}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    interpret_env(monkeypatch)


def _scene():
    """(JAX mesh, JAX renderer without cameras, target (2, 16, 16, 3))."""
    mesh, _cams, lights, rend = build("gaussian", imsize=16, k=16, s=4,
                                      sigma=1e-2, gamma=5e-2, n_views=2)
    rend = rend.replace(
        rasterizer=rend.rasterizer.replace(cameras=None),
        shader=rend.shader.replace(cameras=None, lights=lights))
    target = np.random.default_rng(5).uniform(
        size=(2, 16, 16, 3)).astype(np.float32)
    return mesh, rend, target


def _inits(nv):
    return (np.array(ELEV, np.float32), np.array(AZIM, np.float32),
            np.array(LIGHT, np.float32), np.zeros((nv, 3), np.float32),
            np.ones((1, nv, 3), np.float32))


def _jax_seed_words(key, n, steps):
    """The (n, 4) seed words of each step of JAX's scene loop."""
    words = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        k_rast, k_agg = jax.random.split(sub)
        rows = [[int(w) for k in (k_rast, k_agg)
                 for w in jfr._key_words(jax.random.fold_in(k, i))]
                for i in range(n)]
        words.append(torch.tensor(rows, dtype=torch.int32))
    return words


@pytest.fixture(scope="module")
def jax_run():
    """(mesh, renderer, target, records, losses, final params, checkpoint)
    of JAX's optimize_scene_params over SCHEDULE: each update's (grads,
    params) and boundary 3's checkpoint state."""
    records, saved = [], {}
    multi = optax.multi_transform

    def recording(transforms, labels):
        tx = multi(transforms, labels)

        def update(grads, state, params=None):
            jax.debug.callback(
                lambda g, p: records.append(
                    ({k: np.asarray(v) for k, v in g.items()},
                     {k: np.asarray(v) for k, v in p.items()})),
                grads, params, ordered=True)
            return tx.update(grads, state, params)

        return optax.GradientTransformation(tx.init, update)

    with pytest.MonkeyPatch.context() as mp:
        interpret_env(mp)
        mp.setattr(optax, "multi_transform", recording)
        mp.setattr(jckpt, "save_checkpoint", lambda _d, state, step:
                   saved.setdefault(step, jax.device_get(state)))
        mesh, rend, target = _scene()
        _best, final, losses = jh.optimize_scene_params(
            mesh, *(jnp.asarray(x) for x in _inits(mesh.max_verts)), rend,
            [jnp.asarray(target)], key=jax.random.PRNGKey(SEED),
            checkpoint_dir="unused", param_to_check=PARAMS,
            lr_scales=LR_SCALES, **SCHEDULE)
    assert len(records) == STEPS and sorted(saved) == [STEPS]
    return (mesh, rend, target, records, np.asarray(losses),
            {k: np.asarray(v) for k, v in final.items()}, saved[STEPS])


def _port_params(nv):
    elev, azim, light, deform, rgb = (torch.from_numpy(x)
                                      for x in _inits(nv))
    return {"verts_rgb": rgb, "deform": deform, "camera_elev": elev,
            "camera_azim": azim, "lights_location": light}


def _trainable():
    group = {"verts_rgb": "textures", "deform": "vertices",
             "camera_elev": "camera", "camera_azim": "camera",
             "lights_location": "light"}
    return {k: PARAMS[group[k]] for k in th.SCENE_PARAMS}


def _close_params(name, got, want):
    got, want = got.detach().numpy(), np.asarray(want)
    tol = np.maximum(1e-6 * LR_SCALES.get(name, 1.0),
                     np.spacing(np.abs(want).astype(np.float32)))
    assert np.all(np.abs(got - want) <= tol), (name, got, want)


def test_scene_steps_match_jax(jax_run, one_torch_thread):
    mesh, jrend, target, records, losses, final, _saved = jax_run
    tmesh = convert.from_reference(mesh, device="cpu")
    trend = convert.from_reference(jrend, device="cpu")
    state = th.SceneState.start(_port_params(mesh.max_verts), _trainable())
    opt = th._scene_optimizer("adam", state, LR, LR_SCALES)
    assert [g["lr"] for g in opt.param_groups] == [LR, 20 * LR, 20 * LR]
    seeds = _jax_seed_words(jax.random.PRNGKey(SEED), 2, STEPS)
    ttarget = torch.from_numpy(target)
    for i in range(STEPS):
        jgrads, jparams = records[i]
        for k in th.SCENE_PARAMS:
            _close_params(k, state.params[k], jparams[k])
        state, out = th.scene_step(tmesh, ttarget, state, trend, opt,
                                   seeds[i], textured=True)
        np.testing.assert_allclose(out.loss.item(), losses[i], rtol=1e-5)
        assert sorted(out.grads) == sorted(k for k, v in _trainable().items()
                                           if v)
        for k, g in out.grads.items():
            want = jgrads[k]
            scale = np.abs(want).max()
            assert scale > 0, k
            assert np.abs(g.numpy() - want).max() <= 1e-3 * scale, (k, g,
                                                                    want)
    for k in th.SCENE_PARAMS:
        _close_params(k, state.params[k], final[k])
    assert torch.equal(state.params["deform"], torch.zeros_like(
        state.params["deform"]))
    assert state.best_loss.item() == pytest.approx(losses.min(), rel=1e-5)


def test_scene_schedule_matches_jax(jax_run, monkeypatch, tmp_path,
                                    one_torch_thread):
    """The port's optimize_scene_params over SCHEDULE, fed JAX's seed
    words: the losses within rtol 1e-5; at boundary 3's checkpoint sigma,
    gamma, alpha and the blur within a float32 ulp of JAX's, the sample
    count (8) and lr (lr / 1.5) equal, the parameters as above, and a new
    optimizer in both (JAX's state all 0 but its hyperparameters, the
    port's Adam without state)."""
    mesh, jrend, target, _records, jlosses, _final, js = jax_run
    seeds = iter(_jax_seed_words(jax.random.PRNGKey(SEED), 2, STEPS))
    monkeypatch.setattr(th.fused_render, "draw_seeds",
                        lambda *a, **k: next(seeds))
    tdir = str(tmp_path / "port")
    _tb, _tp, tlosses = th.optimize_scene_params(
        convert.from_reference(mesh, device="cpu"),
        *(torch.from_numpy(x) for x in _inits(mesh.max_verts)),
        convert.from_reference(jrend, device="cpu"),
        [torch.from_numpy(target)], checkpoint_dir=tdir,
        param_to_check=PARAMS, lr_scales=LR_SCALES, **SCHEDULE)
    assert tlosses.shape == (STEPS,)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert checkpoint.latest_step(tdir) == STEPS
    ts = checkpoint.restore_checkpoint(tdir)
    for k in ("sigma", "gamma", "alpha", "blur"):
        want = np.float32(np.asarray(js[k]))
        assert abs(ts[k] - want) <= np.spacing(want), k
    assert ts["nb_samples"] == int(js["nb_samples"]) == 8
    assert ts["lr"] == float(js["lr"]) == LR / 1.5
    for k in th.SCENE_PARAMS:
        _close_params(k, ts["params"][k], js[f"param_{k}"])
    # Adam's moments and counts 0; its hyperparameters b1, b2, eps and
    # the two groups' rates.
    hyper = np.float32([0.9, 0.999, 1e-8, ts["lr"], 20 * ts["lr"]])
    leaves = np.concatenate([np.ravel(x).astype(np.float32)
                             for x in js["opt_leaves"]])
    assert set(np.unique(leaves[leaves != 0])) <= set(hyper)
    assert ts["optimizer"]["state"] == {}
    assert sorted({g["lr"] for g in ts["optimizer"]["param_groups"]}) == [
        ts["lr"], 20 * ts["lr"]]


def test_scene_kill_and_resume_is_bit_equal(tmp_path, one_torch_thread):
    """optimize_scene_params with annealing from step 1 (sigma, gamma, S,
    lr and a new optimizer at the boundaries 2 and 3), killed after two
    one-step segments and resumed: the same params, best params and
    losses, bit for bit."""
    mesh, jrend, target = _scene()
    tmesh = convert.from_reference(mesh, device="cpu")
    trend = convert.from_reference(jrend, device="cpu")
    inits = [torch.from_numpy(x) for x in _inits(mesh.max_verts)]

    def run(**extra):
        return th.optimize_scene_params(
            tmesh, *inits, trend, [torch.from_numpy(target)],
            generator=torch.Generator().manual_seed(4), lr_init=LR, Niter=4,
            segment_size=1, adapt_reg=True, anneal_start=1,
            param_to_check=PARAMS, lr_scales=LR_SCALES, **extra)

    best, params, losses = run()
    ckpt = str(tmp_path / "scene")
    _b, _p, killed = run(checkpoint_dir=ckpt, max_segments=2)
    assert killed.shape == (2,) and checkpoint.latest_step(ckpt) == 2
    st = checkpoint.restore_checkpoint(ckpt)
    assert st["nb_samples"] == 8 and st["lr"] == pytest.approx(LR / 1.5)
    best2, params2, losses2 = run(checkpoint_dir=ckpt, resume=True)
    assert losses.shape == (4,) and np.all(np.isfinite(losses))
    assert np.array_equal(losses2, losses)
    for k in th.SCENE_PARAMS:
        assert torch.equal(params2[k], params[k]), k
        assert torch.equal(best2[k], best[k]), k
