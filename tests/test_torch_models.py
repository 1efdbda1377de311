"""ResNet34 and one PosePredictor iteration: the PyTorch port against Flax.

The Flax variables are perturbed with a seed (the pose head included: a
fresh head is an identity update, which would make the comparison of two
no-ops), carried over with `weights_from_jax`, and both models run on the
same numpy inputs. The JAX renders go through the Pallas kernel in
interpret mode, as `tests/test_rasterizer_pallas.py` runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from happypose_tpu.meshes.database import MeshDataBase as JaxMeshDataBase
from happypose_tpu.meshes.io import make_box_mesh as jax_box
from happypose_tpu.models.backbones import ResNet34 as JaxResNet34
from happypose_tpu.models.pose_predictor import (
    PosePredictor as JaxPosePredictor,
    PosePredictorConfig as JaxConfig,
)
from happypose_tpu_torch.meshes.database import MeshDataBase
from happypose_tpu_torch.meshes.io import make_box_mesh
from happypose_tpu_torch.models.backbones import ResNet34
from happypose_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig
from happypose_tpu_torch.utils.weights_from_jax import (
    pose_predictor_state_dict,
    resnet_state_dict,
)

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

H, W = 96, 128  # observation
RENDER = (48, 64)


def perturb(variables, seed):
    """Seeded perturbation of Flax variables -> nested dicts of numpy arrays.

    Kernels move by 20% of their own spread, BatchNorm affine terms and
    running statistics move away from their (1, 0, 0, 1) init, and the pose
    head kernel gets N(0, 3e-3), so the update moves the pose by a few
    percent instead of being the identity."""
    rs = np.random.RandomState(seed)

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v, path + (k,))
                continue
            x = np.asarray(v, np.float32)
            if k == "kernel" and "pose_fc" in path:
                x = x + rs.normal(0, 3e-3, x.shape)
            elif k == "kernel":
                x = x + rs.normal(0, 0.2 * x.std(), x.shape)
            elif k == "scale":
                x = x * rs.uniform(0.8, 1.2, x.shape)
            elif k in ("bias", "mean"):
                x = x + rs.normal(0, 0.05, x.shape)
            elif k == "var":
                x = x * rs.uniform(0.5, 1.5, x.shape)
            out[k] = x.astype(np.float32)
        return out

    return walk(variables, ())


def test_resnet34_matches_flax():
    """Features of a 9-channel input [B, 9, 96, 128]. Tolerance 1e-4 abs +
    1e-4 rel: float32 convolutions sum up to 4608 products per output in a
    different order than XLA, over 33 layers."""
    rs = np.random.RandomState(0)
    x = rs.rand(2, 9, H, W).astype(np.float32)
    flax_model = JaxResNet34()
    x_nhwc = jnp.asarray(np.moveaxis(x, 1, -1))
    variables = perturb(flax_model.init(jax.random.PRNGKey(0), x_nhwc), seed=1)
    ref = np.asarray(flax_model.apply(variables, x_nhwc, train=False))

    model = ResNet34(n_inputs=9).eval()
    model.load_state_dict(resnet_state_dict(variables["params"], variables["batch_stats"]))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 512)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def icosphere(radius=0.05, n_sub=2):
    """Subdivided icosahedron: well-shaped triangles, no pole slivers."""
    t = (1 + 5 ** 0.5) / 2
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t), (0, 1, t),
             (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9),
             (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2),
             (3, 2, 6), (3, 6, 8), (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10),
             (8, 6, 7), (9, 8, 1)]
    verts = [np.asarray(v, np.float64) for v in verts]
    for _ in range(n_sub):
        cache, new_faces = {}, []

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                cache[key] = len(verts)
                verts.append((verts[i] + verts[j]) / 2)
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces
    v = np.asarray(verts)
    v = radius * v / np.linalg.norm(v, axis=1, keepdims=True)
    colors = np.tile(np.asarray([[0.2, 0.6, 0.3]]), (len(v), 1))
    return v.astype(np.float32), np.asarray(faces, np.int32), colors.astype(np.float32)


def mesh_dbs():
    """The same two meshes in both packages' databases: an icosphere (320
    faces, 5 chunks) and a box. The JAX renders go through the Pallas
    interpreter, which mis-resolves the UV sphere's pole slivers (see
    test_torch_rasterizer.py); an icosphere has none."""
    from happypose_tpu.meshes.io import Mesh as JaxMesh
    from happypose_tpu_torch.meshes.io import Mesh

    v, f, c = icosphere()
    jdb = JaxMeshDataBase({
        "sphere": JaxMesh(vertices=v, faces=f, vertex_colors=c),
        "box": jax_box((0.04, 0.03, 0.05)),
    })
    tdb = MeshDataBase({
        "sphere": Mesh(vertices=v, faces=f, vertex_colors=c),
        "box": make_box_mesh((0.04, 0.03, 0.05)),
    })
    return jdb, tdb


def _scene():
    jdb, tdb = mesh_dbs()
    rs = np.random.RandomState(3)
    images = rs.rand(2, 3, H, W).astype(np.float32)
    K = np.tile(np.asarray([[200.0, 0, W / 2], [0, 200.0, H / 2], [0, 0, 1]], np.float32), (2, 1, 1))
    TCO = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    TCO[:, :3, 3] = [[0.01, -0.005, 0.5], [-0.02, 0.01, 0.45]]
    TCO[:, :3, :3] = Rotation.random(2, random_state=4).as_matrix()
    obj_ids = np.asarray([jdb.id_of("sphere"), jdb.id_of("box")])
    return jdb, tdb, images, K, TCO, obj_ids


@pytest.mark.parametrize("role", ["refiner", "coarse"])
def test_pose_predictor_iteration_matches_flax(role):
    """One iteration (crop, render, ResNet34, head) as refiner and as coarse
    classifier. Crop boxes and K_crop agree to float32 rounding (1e-4 px);
    TCO_output to 1e-5 m / 1e-5 in rotation entries; logits to 1e-4 (the
    ResNet tolerance)."""
    jdb, tdb, images, K, TCO, obj_ids = _scene()
    kw = dict(render_size=RENDER, render_normals=True)
    if role == "coarse":
        kw.update(predict_pose_update=False, predict_rendered_views_logits=True)
    jax_model = JaxPosePredictor(JaxConfig(backbone="resnet34", renderer="pallas_interpret", **kw))
    j_assets, j_meshes = jdb.render_assets(), jdb.batched(n_points=200)
    args = (
        jnp.asarray(images), jnp.asarray(K), jnp.asarray(obj_ids), jnp.asarray(TCO),
        j_assets, j_meshes.select(jnp.asarray(obj_ids)),
    )
    variables = perturb(jax_model.init(jax.random.PRNGKey(0), *args), seed=2)
    ref = jax_model.apply(variables, *args, n_iterations=1)

    model = PosePredictor(PosePredictorConfig(**kw)).eval()
    model.load_state_dict(pose_predictor_state_dict(variables))
    ids = torch.from_numpy(obj_ids)
    with torch.no_grad():
        out = model(
            torch.from_numpy(images), torch.from_numpy(K), ids, torch.from_numpy(TCO),
            tdb.render_assets(device="cpu"), tdb.batched(n_points=200, device="cpu").select(ids),
        )
    np.testing.assert_allclose(out.boxes_crop.numpy(), np.asarray(ref.boxes_crop), atol=1e-4, rtol=0)
    np.testing.assert_allclose(out.K_crop.numpy(), np.asarray(ref.K_crop), atol=1e-4, rtol=1e-6)
    if role == "refiner":
        assert not np.allclose(np.asarray(ref.TCO_output), np.asarray(ref.TCO_input), atol=1e-4)
        np.testing.assert_allclose(out.pose_raw.numpy(), np.asarray(ref.pose_raw), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(out.TCO_output.numpy(), np.asarray(ref.TCO_output), atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(
            out.renderings_logits.numpy(), np.asarray(ref.renderings_logits), atol=1e-4, rtol=1e-4
        )


@pytest.mark.parametrize(
    "norm_type", ["tCR_scale", "tCR_scale_clamp_center", "tCR_center_clamp", "none"]
)
def test_pose_predictor_depth_channels_match_flax(norm_type):
    """One refiner iteration with `input_depth` and `render_depth`: the crop
    carries the observed depth (with holes) as a 4th channel through
    `crop_images_matmul`, each view renders a depth channel, and both are
    normalized by the reference point's depth. The first convolution then
    has 4 + 7 input channels; its Flax kernel carries over by shape.
    `TCO_output` to 1e-5. A crop pixel's depth is zeroed where its
    validity crop is under 0.99; XLA's fused multiply-adds move sample
    positions by an ulp, so the test first checks that no pixel of this
    input sits within 1e-4 of that threshold."""
    jdb, tdb, images, K, TCO, obj_ids = _scene()
    rs = np.random.RandomState(5)
    depth = (0.4 + 0.2 * rs.rand(2, 1, H, W)).astype(np.float32)
    depth[:, :, 20:40, 30:60] = 0.0  # a hole in the observed depth
    images = np.concatenate([images, depth], axis=1)
    kw = dict(render_size=RENDER, render_normals=True, render_depth=True, input_depth=True,
              depth_normalization_type=norm_type)
    jax_model = JaxPosePredictor(JaxConfig(backbone="resnet34", renderer="pallas_interpret", **kw))
    j_assets, j_meshes = jdb.render_assets(), jdb.batched(n_points=200)
    args = (
        jnp.asarray(images), jnp.asarray(K), jnp.asarray(obj_ids), jnp.asarray(TCO),
        j_assets, j_meshes.select(jnp.asarray(obj_ids)),
    )
    variables = perturb(jax_model.init(jax.random.PRNGKey(0), *args), seed=2)
    ref = jax_model.apply(variables, *args, n_iterations=1)

    cfg = PosePredictorConfig(**kw)
    assert cfg.n_render_channels == 7
    model = PosePredictor(cfg).eval()
    model.load_state_dict(pose_predictor_state_dict(variables))
    assert model.backbone.conv1.weight.shape[1] == 4 + 7
    ids = torch.from_numpy(obj_ids)
    meshes = tdb.batched(n_points=200, device="cpu").select(ids)
    with torch.no_grad():
        t_images, t_K, t_TCO = (torch.from_numpy(x) for x in (images, K, TCO))
        out = model(t_images, t_K, ids, t_TCO, tdb.render_assets(device="cpu"), meshes)
        # the crop the model saw: its depth channel has zeroed pixels, and
        # none of them is decided by a validity within 1e-4 of 0.99
        crop, _, _, boxes = model._crop_inputs(
            t_images, t_K, out.TCO_input[0], out.tCR[0], meshes.points, meshes.points_mask)
        from happypose_tpu_torch.ops.crop_resize import roi_align_matmul
        validity = roi_align_matmul((t_images[:, 3:4] > 0).float(), boxes, RENDER, 4)
    assert (crop[:, 3] == 0).any() and (crop[:, 3] > 0).any()
    assert (validity - 0.99).abs().min() > 1e-4
    np.testing.assert_allclose(out.K_crop.numpy(), np.asarray(ref.K_crop), atol=1e-4, rtol=1e-6)
    assert not np.allclose(np.asarray(ref.TCO_output), np.asarray(ref.TCO_input), atol=1e-4)
    np.testing.assert_allclose(out.pose_raw.numpy(), np.asarray(ref.pose_raw), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out.TCO_output.numpy(), np.asarray(ref.TCO_output), atol=1e-5, rtol=0)


def test_unknown_depth_normalization_raises():
    model = PosePredictor(PosePredictorConfig(
        render_size=RENDER, input_depth=True, depth_normalization_type="nope"))
    with pytest.raises(ValueError, match="depth_normalization_type"):
        model._normalize_depth(torch.ones(1, 1, 2, 2), torch.ones(1, 3))
