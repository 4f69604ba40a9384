"""zest_tpu_torch's real-data loaders against zest_tpu's, on the CPU.

Both packages load the same scenes, written from a seed in each loader's
layout by ``zest_tpu_torch.tools.scene_fixtures``, and every sample is
compared key by key: the same keys, shapes and dtypes, and equal arrays
(atol 0: both run the same NumPy and PIL operations on the same bytes).
The loaders' draws (``np.random.default_rng(seed)``) are taken in the same
order, so a training sample with a seed matches too. Images load through
whichever route ``native_io.worth_using`` picks here, the same for both
packages; ``test_pil_route_*`` forces PIL, the native tests compare the
two packages' C++ pipelines bit for bit.
"""
import numpy as np
import pytest
from PIL import Image

import zest_tpu.data as jdata
from zest_tpu import train_loop as jloop
from zest_tpu.config import ZestConfig as JZestConfig
from zest_tpu.data import common as jcommon
from zest_tpu.data import native_io as jnative
from zest_tpu.data import pfm as jpfm
from zest_tpu.data import pose_utils as jpose

import zest_tpu_torch.data as data
from zest_tpu_torch import ZestConfig, train_loop
from zest_tpu_torch.data import common, native_io, pfm, pose_utils
from zest_tpu_torch.tools import scene_fixtures as sf

NSFF = dict(scene="toy", num_keyframes=3, img_h=32, img_w=64)
LLFF = dict(scene="fern", downSample=0.1)
N3DV = dict(scene="coffee_martini", downSample=0.1, keyframe_interval=2)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """One scene of each layout, small: NSFF (5 frames of 128x64, flow at
    64x32), LLFF (8 views of 96x64, two depth maps for ``depth_path``), DTU
    (12 views of its own 640x512 at 7 lights, depth maps for views 0 and 1)
    and Neural 3D Video (7 cameras, 3 frames of 96x64)."""
    root = tmp_path_factory.mktemp("scenes")
    sf.write_nsff_scene(root / "nsff", "toy", n_frames=5, size=(128, 64),
                        flow_size=(64, 32))
    sf.write_llff_scene(root / "llff", "fern", n_views=8, size=(96, 64))
    sf.write_depth_maps(root / "depths", n=2, size=(800, 800))
    sf.write_dtu_config(root / "dtu_cfg", ("scan1",), n_views=12)
    sf.write_dtu_scene(root / "dtu", "scan1", n_views=12, lights=range(7),
                       depth_views=(0, 1))
    sf.write_n3dv_scene(root / "n3dv", "coffee_martini", n_cams=7,
                        n_frames=3, size=(96, 64))
    return root


def assert_same_sample(got, ref, tag=""):
    assert set(got) == set(ref), (tag, set(got) ^ set(ref))
    for k, v in ref.items():
        g, r = np.asarray(got[k]), np.asarray(v)
        assert (g.shape, g.dtype) == (r.shape, r.dtype), (tag, k)
        np.testing.assert_array_equal(g, r, err_msg=f"{tag} {k}")


def assert_same_loader(got, ref, idxs):
    assert len(got) == len(ref)
    for i in idxs:
        assert_same_sample(got[i], ref[i], f"sample {i}")


@pytest.mark.parametrize("opts", [dict(use_mvs=True, use_mvs_dy=True),
                                  dict(),
                                  dict(use_mvs=True),
                                  dict(use_mvs_dy=True, frame_jump=2)])
def test_nsff_samples_equal_zest_tpu(scenes, opts):
    """Frame 0 (no backward flow), a middle frame and the last (no forward
    flow), with and without either volume's views, and frame_jump 2."""
    kw = dict(NSFF, **opts)
    got = data.dataset_dict["nsff"](scenes / "nsff", **kw)
    ref = jdata.dataset_dict["nsff"](scenes / "nsff", **kw)
    assert got.key_frames == ref.key_frames == {"toy": [0, 2, 4]}
    assert_same_loader(got, ref, (0, 3, 4))
    first, last = got[0], got[4]
    np.testing.assert_array_equal(first["flow_bwd"], common.uv_grid(32, 64))
    np.testing.assert_array_equal(last["flow_fwd"], common.uv_grid(32, 64))
    assert not first["mask_bwd"].any() and not last["mask_fwd"].any()


@pytest.mark.parametrize("split,depth,closest", [("train", False, False),
                                                 ("train", True, False),
                                                 ("train", True, True),
                                                 ("test", False, False)])
def test_llff_samples_equal_zest_tpu(scenes, split, depth, closest):
    """Training samples draw the views and then the depth file from the
    loader's seeded generator; both packages draw the same. Three samples
    in a row, so later draws are compared too."""
    kw = dict(LLFF, split=split, seed=3, closest_views=closest,
              depth_path=scenes / "depths" if depth else None)
    got = data.dataset_dict["llff"](scenes / "llff", **kw)
    ref = jdata.dataset_dict["llff"](scenes / "llff", **kw)
    assert_same_loader(got, ref, (0, 4, 4, 7))
    assert bool(np.abs(got[1]["depths"]).max() > 0) == depth


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("closest", [False, True])
def test_dtu_samples_equal_zest_tpu(scenes, split, closest):
    kw = dict(config_dir=scenes / "dtu_cfg", split=split, seed=1,
              closest_views=closest, downSample=0.25)
    got = data.dataset_dict["dtu"](scenes / "dtu", **kw)
    ref = jdata.dataset_dict["dtu"](scenes / "dtu", **kw)
    assert len(got) == 12 * (7 if split == "train" else 1)
    assert_same_loader(got, ref, (0, 1))
    assert got[0]["images"].shape == (4, 128, 160, 3)


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("key_frames", [False, True])
def test_neural3dvideo_samples_equal_zest_tpu(scenes, split, key_frames):
    kw = dict(N3DV, split=split, seed=2, train_key_frames=key_frames)
    got = data.dataset_dict["neural3Dvideo"](scenes / "n3dv", **kw)
    ref = jdata.dataset_dict["neural3Dvideo"](scenes / "n3dv", **kw)
    assert len(got) == 7 * (2 if key_frames else 3)
    assert_same_loader(got, ref, range(0, len(got), 3))
    assert int(got[len(got) - 1]["keyframe_id"]) == (1 if key_frames else 2)


def _cfg(name, root, **kw):
    fields = {"nsff": dict(datadir=root / "nsff", finetune_scene="toy",
                           num_keyframes=3, img_h=32, img_w=64, use_mvs=True,
                           use_mvs_dy=True),
              "llff": dict(datadir=root / "llff", finetune_scene="fern",
                           imgScale_train=0.1, imgScale_test=0.1,
                           depth_path=str(root / "depths")),
              "dtu": dict(datadir=root / "dtu", configdir=root / "dtu_cfg",
                          imgScale_train=0.25, imgScale_test=0.25),
              "neural3Dvideo": dict(datadir=root / "n3dv",
                                    finetune_scene="coffee_martini",
                                    imgScale_train=0.1, imgScale_test=0.1),
              "synthetic": dict(img_h=32, img_w=64, num_keyframes=3)}[name]
    fields = {k: str(v) if k.endswith("dir") else v for k, v in fields.items()}
    return dict(fields, dataset_name=name, **kw)


@pytest.mark.parametrize("name", ["nsff", "llff", "dtu", "neural3Dvideo",
                                  "synthetic"])
def test_build_datasets_matches_zest_tpu(scenes, name):
    """Each dataset_name with zest_tpu's keyword arguments, per split. The
    training loaders are unseeded (fresh OS entropy) in both packages, so
    their first samples are compared only where no draw is taken."""
    fields = _cfg(name, scenes)
    got = train_loop.build_datasets(ZestConfig(**fields), ("train", "val",
                                                           "test"))
    ref = jloop.build_datasets(JZestConfig(**fields), ("train", "val",
                                                       "test"))
    for split in ("train", "val", "test"):
        assert type(got[split]).__name__ == type(ref[split]).__name__
        assert len(got[split]) == len(ref[split]), split
        if split != "train" or name in ("nsff", "synthetic"):
            assert_same_sample(got[split][0], ref[split][0], split)
    if name == "dtu":
        assert len(got["val"]) == 10
    if name == "llff":
        assert got["train"].depth_files and not got["test"].depth_files


def test_neural3dvideo_key_frames_reach_the_loader(scenes):
    """``key_frames`` selects the keyframe-only samples. zest_tpu's
    build_datasets tests the name "neural3dvideo" and never passes it; the
    port passes it, and its loader equals zest_tpu's loader given it."""
    fields = _cfg("neural3Dvideo", scenes, key_frames=True)
    got = train_loop.build_datasets(ZestConfig(**fields), ("test",))["test"]
    ref = jdata.dataset_dict["neural3Dvideo"](
        str(scenes / "n3dv"), split="test", downSample=0.1,
        scene="coffee_martini", train_key_frames=True)
    assert got.train_key_frames and len(got) == len(ref) == 7
    assert_same_loader(got, ref, (0, 6))


def test_motion_mask_keeps_the_first_16384_coordinates(tmp_path):
    """A mask of more than MOTION_COORDS_PAD pixels keeps its first 16,384
    row-major coordinates in both packages: the training step draws only
    from those."""
    sf.write_nsff_scene(tmp_path, "big", n_frames=4, size=(256, 128),
                        mask_radius=0.9)
    kw = dict(scene="big", num_keyframes=4, img_h=128, img_w=256)
    got = data.dataset_dict["nsff"](tmp_path, **kw)[1]
    ref = jdata.dataset_dict["nsff"](tmp_path, **kw)[1]
    assert_same_sample(got, ref)
    mask = common.load_image(tmp_path / "big/motion_masks/00001.png",
                             (256, 128))[..., 0] > 1e-3
    assert mask.sum() > common.MOTION_COORDS_PAD
    assert int(got["motion_count"]) == common.MOTION_COORDS_PAD == 16384
    np.testing.assert_array_equal(got["motion_coords"],
                                  np.argwhere(mask)[:16384])


def test_pose_utils_equal_zest_tpu():
    rng = np.random.default_rng(0)
    rot = np.linalg.qr(rng.normal(size=(9, 3, 3)))[0]
    poses = np.concatenate([rot, rng.normal(size=(9, 3, 1))], -1)
    for a, b in zip(pose_utils.center_poses(poses), jpose.center_poses(poses)):
        np.testing.assert_array_equal(a, b)
    c2ws = np.tile(np.eye(4), (9, 1, 1))
    c2ws[:, :3] = pose_utils.center_poses(poses)[0]
    for method in ("vector", "matrix", "dist"):
        for tar_id, n in ((-1, 9), (4, 5), (0, 20)):
            np.testing.assert_array_equal(
                pose_utils.get_nearest_pose_ids(c2ws[4], c2ws, n, tar_id,
                                                method, (0.1, 0, -1)),
                jpose.get_nearest_pose_ids(c2ws[4], c2ws, n, tar_id, method,
                                           (0.1, 0, -1)))
    with pytest.raises(ValueError):
        pose_utils.get_nearest_pose_ids(c2ws[0], c2ws, 3,
                                        angular_dist_method="cosine")


@pytest.mark.parametrize("shape", [(7, 5), (6, 4, 3)])
def test_read_pfm_equals_zest_tpu(tmp_path, shape):
    rng = np.random.default_rng(1)
    arr = rng.normal(size=shape).astype(np.float32)
    path = tmp_path / "d.pfm"
    if len(shape) == 2:
        sf.write_pfm(path, arr)
    else:                      # a colour PFM, big-endian
        with open(path, "wb") as f:
            f.write(f"PF\n{shape[1]} {shape[0]}\n1.0\n".encode())
            np.flipud(arr).astype(">f4").tofile(f)
    got, scale = pfm.read_pfm(path)
    ref, ref_scale = jpfm.read_pfm(path)
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(got, ref)
    assert scale == ref_scale == 1.0


def test_common_helpers_equal_zest_tpu():
    rng = np.random.default_rng(2)
    img = rng.uniform(size=(20, 30, 3)).astype(np.float32)
    for method in ("lanczos", "nearest", "bilinear"):
        for arr in (img, img[..., 0]):
            np.testing.assert_array_equal(
                common.resize_image(arr, (17, 11), method),
                jcommon.resize_image(arr, (17, 11), method))
    np.testing.assert_array_equal(common.imagenet_normalize(img),
                                  jcommon.imagenet_normalize(img))
    np.testing.assert_array_equal(common.uv_grid(5, 7), jcommon.uv_grid(5, 7))
    for n in (0, 3, 20):
        coords = rng.integers(0, 9, (n, 2)).astype(np.float32)
        for a, b in zip(common.pad_motion_coords(coords, 16),
                        jcommon.pad_motion_coords(coords, 16)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


PIL_ROUTE = {
    "nsff": ("nsff", dict(NSFF, use_mvs=True, use_mvs_dy=True), (1,)),
    "llff": ("llff", dict(LLFF, seed=0), (1,)),
    "dtu": ("dtu", dict(split="test", seed=1, downSample=0.25), (0,)),
    "neural3Dvideo": ("n3dv", dict(N3DV, seed=2), (1,))}


@pytest.mark.parametrize("name", list(PIL_ROUTE))
def test_pil_route_samples_equal_zest_tpu(scenes, monkeypatch, name):
    """With ``ZEST_NATIVE_IO=0`` both packages decode with PIL, the route
    the card's machine takes, and the port says so
    (``native_io.last_route``)."""
    monkeypatch.setenv("ZEST_NATIVE_IO", "0")
    root, kw, idxs = PIL_ROUTE[name]
    if name == "dtu":
        kw = dict(kw, config_dir=scenes / "dtu_cfg")
    got = data.dataset_dict[name](scenes / root, **kw)
    ref = jdata.dataset_dict[name](scenes / root, **kw)
    assert_same_loader(got, ref, idxs)
    assert native_io.last_route() == ("pil", "ZEST_NATIVE_IO=0")


def _native_or_skip():
    if native_io.get_lib() is None:
        pytest.skip(f"the native pipeline does not build here: "
                    f"{native_io.build_error()}")
    if jnative.get_lib() is None:
        pytest.skip("zest_tpu's native pipeline does not build here")


def test_native_loads_equal_zest_tpu_and_pil(scenes, monkeypatch):
    """The port's C++ pipeline, built into build/zest_tpu_torch/, equals
    zest_tpu's bit for bit, and PIL within 8-bit rounding
    (tests/test_native_io.py's tolerance)."""
    _native_or_skip()
    monkeypatch.setenv("ZEST_NATIVE_IO", "1")
    paths = sorted((scenes / "nsff" / "toy" / "images").glob("*.png"))
    for wh in ((64, 32), (128, 64), (160, 80)):
        got = common.load_images(paths, wh)
        assert native_io.last_route() == ("native", None)
        np.testing.assert_array_equal(got, jnative.load_images_native(paths, wh))
        for p, g in zip(paths, got):
            pil = np.asarray(Image.open(p).convert("RGB")
                             .resize(wh, Image.LANCZOS), np.float32) / 255.0
            assert np.abs(g - pil).max() <= 2.5 / 255.0
            assert (np.abs(g - pil) > 0.5 / 255.0).mean() < 0.02
            np.testing.assert_array_equal(common.load_image(p, wh), g)
    assert native_io.library_path().parent.parts[-2:] == ("build",
                                                          "zest_tpu_torch")
    assert native_io.load_image_native(scenes / "missing.png", (8, 8)) is None


def test_native_route_samples_equal_zest_tpu(scenes, monkeypatch):
    _native_or_skip()
    monkeypatch.setenv("ZEST_NATIVE_IO", "1")
    kw = dict(NSFF, use_mvs=True, use_mvs_dy=True)
    got = data.dataset_dict["nsff"](scenes / "nsff", **kw)
    ref = jdata.dataset_dict["nsff"](scenes / "nsff", **kw)
    assert_same_loader(got, ref, (2,))
    assert native_io.last_route() == ("native", None)
