"""`happypose_tpu_torch/parallel/`, object-sharded assets and `schur_sharded`
bundle adjustment, at world sizes 1 and 2, against the JAX package on its
virtual CPU devices (sharded coarse scoring: `test_torch_parallel_scoring.py`,
training: `test_torch_parallel_training.py`).

Each world size is one spawn of gloo ranks (`torch.multiprocessing`,
start method "spawn", rendezvous through a `FileStore` under the test's
temporary directory, so the xdist workers never share a port). A rank runs
every check of `_rank_body` and writes what it got; the tests compare the
ranks' results with each other, with the port in one process and with
JAX. This module imports only torch, numpy and the port at module level:
a spawned rank imports it to find its body, and JAX there would cost
seconds a rank.

Tolerances, and why:
- collectives, placement, object-sharded selects and renders: exact (a sum
  with zeros, a broadcast and a gather move values without arithmetic);
- `sharded_batch_apply` against JAX's: 1e-6 (one float32 dot product);
- a `schur_sharded` LM step by the poses it gives, 2e-3, as
  `tests/test_ba_schur.py:194-219` holds JAX's own sharded step to its
  serial one (the truncated pseudo-inverse amplifies reduction-order noise
  along the ortho6d directions that do not move a pose); its loss 1e-5.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from happypose_tpu_torch.multiview.bundle_adjustment import MultiviewRefinement
from happypose_tpu_torch.ops.rasterizer_fused import render_batch_fused
from happypose_tpu_torch.parallel import (
    gather_predictions, make_mesh, reduce_dict, replicate, shard_leading, sharded_batch_apply,
    sync_model,
)
from happypose_tpu_torch.parallel.mesh import pad_objects_to_multiple, shard_objects

WORLDS = (1, 2)
# a step at lambda 1e-3 is float noise along the ortho6d directions that do
# not move a pose, and its poses scatter by ~2e-3 between reduction orders
# (JAX's own sharded and serial steps, `tests/test_ba_schur.py`); at 1e4 the
# system is well posed and the port's step is JAX's to 1e-5 in the poses
# (`tests/test_torch_multiview.py`, `SCHUR_POSE_ATOL`)
BA_LAMBDAS = (1e-3, 1e4)


# ---------------------------------------------------------------- spawning


def _entry(rank, world, store_path, body, out_dir, inputs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        torch.save(body(rank, world, inputs), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(body, world, tmp_dir, inputs):
    """Run `body(rank, world, inputs)` on `world` spawned gloo ranks; returns
    each rank's result."""
    os.makedirs(tmp_dir, exist_ok=True)
    mp.start_processes(_entry, args=(world, os.path.join(tmp_dir, "store"), body, tmp_dir, inputs),
                       nprocs=world, start_method="spawn", join=True)
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------- rank body


def _score(batch):
    x, y = batch
    return torch.sum(x * y, dim=-1) + torch.tanh(x[:, 0])


def _rank_body(rank, world, inputs):
    out = {}
    mesh = make_mesh((world,), ("hp",), device_type="cpu")

    # sharded_batch_apply: every rank gets the whole result
    x, y = (torch.from_numpy(inputs[k]) for k in ("x", "y"))
    out["sharded_apply"] = sharded_batch_apply(_score, mesh, axis="hp")((x, y)).numpy()

    # placement
    a = torch.arange(16.0).reshape(8, 2)
    out["shard_leading"] = shard_leading({"a": a, "s": torch.tensor(3.0)}, mesh, "hp")
    out["replicate"] = replicate([torch.full((3,), float(rank + 1))], mesh, "hp")[0]
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(rank + 1.0)
    out["sync_model"] = sync_model(lin.state_dict())["weight"]

    # gather_predictions and reduce_dict
    out["gathered"] = gather_predictions({"poses": torch.full((2, 4), float(rank)),
                                          "ids": torch.tensor([rank, 7])})
    out["reduced"] = {k: float(v) for k, v in reduce_dict(
        {"loss": torch.tensor(float(rank)), "acc": 2.0 * rank + 1}, mesh, "hp").items()}

    # object-sharded assets: the select and the render through it
    db = inputs["db"]
    assets = db.render_assets(device="cpu")
    meshes = db.batched(n_points=32, device="cpu")
    sharded_assets = shard_objects(pad_objects_to_multiple(assets, world), mesh, "hp")
    sharded_meshes = shard_objects(pad_objects_to_multiple(meshes, world), mesh, "hp")
    ids, TCO, K = (torch.from_numpy(inputs[k]) for k in ("ids", "TCO", "K"))
    rep = render_batch_fused(assets, ids, TCO, K, resolution=(60, 80))
    sh = render_batch_fused(sharded_assets, ids, TCO, K, resolution=(60, 80))
    out["render"] = {k: (getattr(rep, k).numpy(), getattr(sh, k).numpy())
                     for k in ("rgb", "depth", "mask", "normals")}
    out["n_local_objects"] = sharded_assets.local.vertices.shape[0]
    out["meshes_select"] = [(getattr(meshes.select(ids), f.name).numpy(),
                             getattr(sharded_meshes.select(ids), f.name).numpy())
                            for f in dataclasses.fields(meshes)]

    # schur_sharded: one LM step (12 candidates, and 11 so that 2 ranks pad)
    ba = inputs["ba"]
    ba_mesh = make_mesh((world,), ("ba",), device_type="cpu")
    out["ba_step"], out["ba_solve"] = {}, {}
    for n in (12, 11):
        args = {k: (v[:n] if k.startswith("cand_") else v) for k, v in ba["args"].items()}
        r = MultiviewRefinement(meshes=ba["tm"], solver="schur_sharded", device="cpu",
                                device_mesh=ba_mesh, **args)
        params = torch.from_numpy(ba["params"])
        nobj = r.n_objects * 9
        tgt = r._align_targets(params[:nobj].reshape(-1, 9), params[nobj:].reshape(-1, 9))
        for lambd in BA_LAMBDAS:
            p, loss = r._lm_step_schur_sharded(params, tgt, lambd, 25.0)
            out["ba_step"][n, lambd] = (p.numpy(), float(loss), r._sh_pad)
    r = MultiviewRefinement(meshes=ba["tm"], solver="schur_sharded", device="cpu",
                            device_mesh=ba_mesh, **ba["args"])
    out["ba_solve"] = r.solve(ba["view_pairs"], ba["TC1C2"], n_iterations=25)["loss"]

    return out


# ---------------------------------------------------------------- inputs


def _render_db():
    """Five objects (icospheres and boxes: no pole slivers), so that two
    ranks pad the object axis."""
    from happypose_tpu.meshes.database import MeshDataBase as JaxMeshDataBase
    from happypose_tpu.meshes.io import Mesh as JaxMesh, make_box_mesh as jax_box
    from happypose_tpu_torch.meshes.database import MeshDataBase
    from happypose_tpu_torch.meshes.io import Mesh, make_box_mesh
    from test_torch_models import icosphere

    jm, tm = {}, {}
    for i in range(5):
        if i % 2:
            v, f, c = icosphere(radius=0.03 + 0.005 * i)
            jm[f"obj_{i}"] = JaxMesh(vertices=v, faces=f, vertex_colors=c)
            tm[f"obj_{i}"] = Mesh(vertices=v, faces=f, vertex_colors=c)
        else:
            ext = (0.03 + 0.004 * i, 0.025, 0.04)
            jm[f"obj_{i}"], tm[f"obj_{i}"] = jax_box(ext), make_box_mesh(ext)
    return JaxMeshDataBase(jm), MeshDataBase(tm)


def _ba_inputs():
    """`tests/test_torch_multiview.py`'s 4-view, 3-object problem (12
    candidates) and JAX's `schur` steps on it and on its first 11."""
    import jax.numpy as jnp

    from happypose_tpu.multiview import bundle_adjustment as jba
    from test_torch_multiview import _both_meshes, _problem

    prob = _problem(_both_meshes(symmetric=False))
    from happypose_tpu_torch.multiview import bundle_adjustment as tba

    ref = {}
    for n in (12, 11):
        args = {k: (v[:n] if k.startswith("cand_") else v) for k, v in prob["args"].items()}
        j = jba.MultiviewRefinement(meshes=prob["jm"], solver="schur", **args)
        t = tba.MultiviewRefinement(meshes=prob["tm"], solver="schur", device="cpu", **args)
        p = jnp.asarray(prob["params"])
        nobj = j.n_objects * 9
        tgt = j._align_targets(p[:nobj].reshape(-1, 9), p[nobj:].reshape(-1, 9))
        tp = torch.from_numpy(prob["params"])
        ttgt = t._align_targets(tp[:nobj].reshape(-1, 9), tp[nobj:].reshape(-1, 9))
        for lambd in BA_LAMBDAS:
            jp, jl = j._lm_step_schur(p, tgt, lambd, 25.0)
            ref[n, lambd] = dict(jax=(np.asarray(jp), float(jl)),
                                 port=t._lm_step_schur(tp, ttgt, lambd, 25.0)[0].numpy())
    inputs = dict(tm=prob["tm"], args=prob["args"], params=prob["params"],
                  view_pairs=prob["view_pairs"], TC1C2=prob["TC1C2"])
    return inputs, ref, prob


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jdb, tdb = _render_db()
    rs = np.random.RandomState(0)
    B = 8
    TCO = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    TCO[:, 2, 3] = 0.45
    TCO[:, :2, 3] = rs.uniform(-0.02, 0.02, (B, 2))
    inputs = dict(
        x=rs.randn(64, 16).astype(np.float32), y=rs.randn(64, 16).astype(np.float32),
        db=tdb, ids=np.asarray([0, 1, 2, 3, 4, 1, 2, 4]), TCO=TCO,
        K=np.tile(np.asarray([[200.0, 0, 40], [0, 200.0, 30], [0, 0, 1]], np.float32), (B, 1, 1)),
    )
    inputs["ba"], ba_ref, prob = _ba_inputs()
    ranks = {w: spawn(_rank_body, w, str(tmp_path_factory.mktemp(f"world{w}")), inputs)
             for w in WORLDS}
    return dict(ranks=ranks, inputs=inputs, jdb=jdb, ba_ref=ba_ref, prob=prob)


# ---------------------------------------------------------------- tests


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_batch_apply_matches_jax(runs, world):
    """`tests/test_parallel.py:27-39`'s score function: JAX's `shard_map`
    over 8 virtual devices and the port's over 1 or 2 ranks give the
    unsharded result on every rank."""
    import jax
    import jax.numpy as jnp

    from happypose_tpu.parallel import make_mesh as jax_make_mesh
    from happypose_tpu.parallel import shard_leading as jax_shard_leading
    from happypose_tpu.parallel import sharded_batch_apply as jax_sharded_batch_apply

    def score(batch):
        x, y = batch
        return jnp.sum(x * y, axis=-1) + jnp.tanh(x[:, 0])

    jmesh = jax_make_mesh((8,), ("hp",))
    xy = tuple(jnp.asarray(runs["inputs"][k]) for k in ("x", "y"))
    ref = np.asarray(jax_sharded_batch_apply(score, jmesh, axis="hp")(
        jax_shard_leading(xy, jmesh, "hp")))
    assert jax.device_count() == 8
    for r in runs["ranks"][world]:
        assert r["sharded_apply"].shape == (64,)
        np.testing.assert_allclose(r["sharded_apply"], ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_placement(runs, world):
    """`shard_leading` keeps the rank's contiguous block, as a JAX shard
    holds its device's rows (rank-0 tensors whole); `replicate` and
    `sync_model` give every rank rank 0's tensors."""
    import jax.numpy as jnp

    from happypose_tpu.parallel import make_mesh as jax_make_mesh
    from happypose_tpu.parallel import shard_leading as jax_shard_leading

    a = np.arange(16.0).reshape(8, 2)
    xs = jax_shard_leading(jnp.asarray(a), jax_make_mesh((world,), ("hp",)), "hp")
    jax_blocks = [np.asarray(s.data) for s in sorted(xs.addressable_shards,
                                                      key=lambda s: s.index[0].start or 0)]
    for rank, r in enumerate(runs["ranks"][world]):
        np.testing.assert_array_equal(r["shard_leading"]["a"].numpy(), jax_blocks[rank])
        assert float(r["shard_leading"]["s"]) == 3.0
        np.testing.assert_array_equal(r["replicate"].numpy(), np.ones(3))
        np.testing.assert_array_equal(r["sync_model"].numpy(), np.ones((2, 3)))


@pytest.mark.parametrize("world", WORLDS)
def test_gather_predictions_stacks_a_new_axis(runs, world):
    """JAX's `process_allgather` stacks along a new leading axis of size
    world; in a single process the tree comes back unchanged."""
    for r in runs["ranks"][world]:
        g = r["gathered"]
        if world == 1:
            np.testing.assert_array_equal(g["poses"].numpy(), np.zeros((2, 4)))
            np.testing.assert_array_equal(g["ids"].numpy(), [0, 7])
        else:
            np.testing.assert_array_equal(
                g["poses"].numpy(), np.stack([np.full((2, 4), float(k)) for k in range(world)]))
            np.testing.assert_array_equal(g["ids"].numpy(), [[k, 7] for k in range(world)])


@pytest.mark.parametrize("world", WORLDS)
def test_reduce_dict_is_jax_pmean(runs, world):
    """Rank r's {loss: r, acc: 2r + 1} averaged over the axis, as JAX's
    `reduce_dict` (`pmean` under `shard_map`) averages the same values
    over `world` virtual devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from happypose_tpu.parallel import make_mesh as jax_make_mesh
    from happypose_tpu.parallel import reduce_dict as jax_reduce_dict

    jmesh = jax_make_mesh((world,), ("hp",))
    ranks = jnp.arange(world, dtype=jnp.float32)
    fn = jax.shard_map(lambda r: jax_reduce_dict({"loss": r, "acc": 2 * r + 1}, "hp"),
                       mesh=jmesh, in_specs=P("hp"), out_specs=P())
    ref = {k: float(v[0]) for k, v in fn(ranks).items()}
    for r in runs["ranks"][world]:
        assert r["reduced"] == pytest.approx(ref, abs=1e-7)


@pytest.mark.parametrize("world", WORLDS)
def test_object_sharded_render_equals_replicated(runs, world):
    """`tests/test_parallel.py:170-210` in the port: five objects, padded to
    a multiple of the world and split over the ranks, render exactly as the
    whole database does (every field of every image, on every rank), and
    the sharded select of the point sets equals the replicated one. The
    replicated render is JAX's two-pass render's to 1e-4 in depth with equal
    masks (`tests/test_torch_rasterizer.py` measures that bound)."""
    import jax.numpy as jnp

    from happypose_tpu.ops.rasterizer import render_batch

    inp = runs["inputs"]
    ref = render_batch(runs["jdb"].render_assets(), jnp.asarray(inp["ids"]),
                       jnp.asarray(inp["TCO"]), jnp.asarray(inp["K"]), resolution=(60, 80))
    for r in runs["ranks"][world]:
        assert r["n_local_objects"] == -(-5 // world)
        for k, (rep, sh) in r["render"].items():
            np.testing.assert_array_equal(sh, rep, err_msg=k)
        for rep, sh in r["meshes_select"]:
            np.testing.assert_array_equal(sh, rep)
        mask = r["render"]["mask"][0]
        assert 0.05 < mask.mean() < 0.9
        np.testing.assert_array_equal(mask, np.asarray(ref.mask))
        np.testing.assert_allclose(r["render"]["depth"][0], np.asarray(ref.depth), atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("n_cands", [12, 11])
@pytest.mark.parametrize("lambd", BA_LAMBDAS)
def test_schur_sharded_step_matches_jax(runs, world, n_cands, lambd):
    """One `schur_sharded` LM step (each rank's block sums, one all-reduce,
    the reduced solve on every rank), the same on every rank: its loss is
    JAX's `schur` step's to 1e-5; its poses are the port's serial `schur`
    step's to 2e-3 at lambda 1e-3 and JAX's to 1e-5 at 1e4 (`BA_LAMBDAS`).
    11 candidates over 2 ranks take one zero-weight padding candidate."""
    from happypose_tpu.lib3d.transforms import pose9d_to_T
    import jax.numpy as jnp

    def poses(p):
        return np.asarray(pose9d_to_T(jnp.asarray(p).reshape(-1, 9)))

    ref = runs["ba_ref"][n_cands, lambd]
    jp, jl = ref["jax"]
    for r in runs["ranks"][world]:
        p, loss, pad = r["ba_step"][n_cands, lambd]
        assert pad == -n_cands % world
        np.testing.assert_allclose(loss, jl, rtol=1e-5)
        if lambd < 1:
            np.testing.assert_allclose(poses(p), poses(ref["port"]), atol=2e-3, rtol=0)
        else:
            np.testing.assert_allclose(poses(p), poses(jp), atol=1e-5, rtol=0)
    first, last = runs["ranks"][world][0], runs["ranks"][world][-1]
    assert first["ba_step"][n_cands, lambd][0].tobytes() == \
        last["ba_step"][n_cands, lambd][0].tobytes()


@pytest.mark.parametrize("world", WORLDS)
def test_schur_sharded_solve_matches_jax(runs, world):
    """The whole LM solve (25 iterations) on the ranks ends at JAX's
    `schur_sharded` solve's loss on 8 virtual devices (both keep the
    reference's step sign: every step is rejected alike)."""
    from jax.sharding import Mesh
    import jax

    from happypose_tpu.multiview import bundle_adjustment as jba

    prob = runs["prob"]
    j = jba.MultiviewRefinement(meshes=prob["jm"], solver="schur_sharded",
                                device_mesh=Mesh(np.array(jax.devices("cpu")[:8]), ("ba",)),
                                **prob["args"])
    ref = j.solve(prob["view_pairs"], prob["TC1C2"], n_iterations=25)["loss"]
    for r in runs["ranks"][world]:
        np.testing.assert_allclose(r["ba_solve"], ref, rtol=1e-5)
