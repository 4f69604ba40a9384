"""Scene directories written from a seed in each real-data loader's layout
(NSFF, LLFF, DTU, Neural 3D Video), for tests and smoke runs: no real scene
ships with the repository. NumPy and PIL only; nothing on the main path
imports this module.

Each writer takes the directory to write under, the scene's name, its
size and a seed, and returns the scene's directory. The images are smooth
moving patterns with a little noise (so that PNG decodes cost what a
photograph's do), the cameras a forward-facing arc (DTU: an arc around the
object, in its millimetres), the poses in LLFF's ``poses_bounds.npy``
format: per camera a [3, 5] matrix (the c2w columns -y, x, z, t and the
image's height, width and focal) and the near and far bounds.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np


def _pattern(rng, H, W, t=0.0, noise=4):
    """[H, W, 3] uint8: a sinusoid in x plus one in y per channel, moving
    with t, plus uniform noise of +-noise levels."""
    x = np.arange(W, dtype=np.float32) / W
    y = np.arange(H, dtype=np.float32)[:, None] / H
    f = rng.uniform(1.0, 5.0, (3, 2))
    p = rng.uniform(0.0, 2 * np.pi, (3, 2))
    img = np.stack([127.5 + 63.75 * np.sin(2 * np.pi * f[c, 0] * x + p[c, 0]
                                           + 0.3 * t)
                    + 63.75 * np.cos(2 * np.pi * f[c, 1] * y + p[c, 1]
                                     + 0.2 * t) for c in range(3)], -1)
    img = img + rng.integers(-noise, noise + 1, (H, W, 3), dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def _save(path, arr):
    """A PNG at zlib level 1 (written fast; it decodes as fast as level 6),
    or a JPEG at quality 95."""
    from PIL import Image
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix == ".jpg":
        Image.fromarray(arr).save(path, quality=95)
    else:
        Image.fromarray(arr).save(path, compress_level=1)


def _each(fn, n):
    """fn(i) for i < n on a pool of threads (the encoders release the GIL);
    each item draws from its own generator, so the files do not depend on
    the order."""
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        list(pool.map(fn, range(n)))


def _llff_row(c2w, hwf, bounds):
    """One ``poses_bounds.npy`` row of a c2w [3, 4] (x right, y up, z back)."""
    m = np.stack([-c2w[:, 1], c2w[:, 0], c2w[:, 2], c2w[:, 3],
                  np.asarray(hwf, np.float64)], 1)
    return np.concatenate([m.reshape(-1), bounds])


def _look(center, target=(0.0, 0.0, -10.0)):
    """c2w [3, 4] at ``center`` looking at ``target`` down its -z axis."""
    center = np.asarray(center, np.float64)
    z = center - np.asarray(target, np.float64)
    z /= np.linalg.norm(z)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z, center], 1)


def _arc_poses(rng, n, span, hwf, near=(2.0, 3.0), far=(12.0, 20.0)):
    """[n, 17] poses_bounds of n cameras on a forward-facing arc from -span
    to span in x, up to span / 3 in y, jittered, looking 10 units ahead."""
    rows = []
    for i in range(n):
        u = i / max(n - 1, 1)
        center = np.array([span * (2 * u - 1), span / 3 * np.sin(2 * np.pi * u),
                           0.0]) + rng.normal(0.0, span / 20, 3)
        rows.append(_llff_row(_look(center), hwf,
                              [rng.uniform(*near), rng.uniform(*far)]))
    return np.stack(rows)


def write_pfm(path, arr):
    """A little-endian single-channel PFM of [H, W] float32 (rows stored
    bottom-up, as ``data.pfm.read_pfm`` reads them)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{arr.shape[1]} {arr.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        np.flipud(np.asarray(arr, "<f4")).tofile(f)


def write_nsff_scene(root, scene="kid-running", n_frames=24, size=(1024, 576),
                     seed=0, flow_size=None, mask_radius=0.15):
    """An NSFF scene: ``images/`` (PNG at ``size``, width x height),
    ``disp/*.npy``, ``motion_masks/`` (a disc of ``mask_radius`` x the
    height that crosses the frame), ``flow_i1/`` (forward flow of frames
    0..n-2 and backward flow of 1..n-1, each .npz a flow [h, w, 2] and a
    mask [h, w]) at ``flow_size`` (default ``size``; the loader resizes
    them, it does not rescale the flow), and ``dense/poses_bounds.npy``."""
    d = Path(root) / scene
    W, H = size
    w, h = flow_size or size
    for sub in ("disp", "flow_i1", "dense"):
        (d / sub).mkdir(parents=True, exist_ok=True)

    def frame(t):
        rng = np.random.default_rng([seed, t])
        _save(d / "images" / f"{t:05d}.png", _pattern(rng, H, W, t))
        yy, xx = np.mgrid[0:H, 0:W]
        cx = W * (0.2 + 0.6 * t / max(n_frames - 1, 1))
        disc = (xx - cx) ** 2 + (yy - H / 2) ** 2 < (mask_radius * H) ** 2
        _save(d / "motion_masks" / f"{t:05d}.png",
              (disc * 255).astype(np.uint8))
        np.save(d / "disp" / f"{t:05d}.npy",
                rng.uniform(0.05, 0.5, (h, w)).astype(np.float32))
        for kind, ok in (("fwd", t < n_frames - 1), ("bwd", t > 0)):
            if ok:
                np.savez(d / "flow_i1" / f"{t:05d}_{kind}.npz",
                         flow=rng.normal(0.0, 2.0, (h, w, 2)).astype(np.float32),
                         mask=rng.uniform(size=(h, w)) > 0.2)

    _each(frame, n_frames)
    np.save(d / "dense" / "poses_bounds.npy",
            _arc_poses(np.random.default_rng(seed), n_frames, 0.3,
                       [H, W, 1.1 * W]))
    return d


def write_llff_scene(root, scene="fern", n_views=20, size=(1008, 756), seed=0):
    """An LLFF scene: ``images_4/`` (PNG at ``size``) and
    ``poses_bounds.npy``."""
    d = Path(root) / scene
    W, H = size
    _each(lambda i: _save(d / "images_4" / f"image{i:03d}.png",
                          _pattern(np.random.default_rng([seed, i]), H, W, i)),
          n_views)
    np.save(d / "poses_bounds.npy",
            _arc_poses(np.random.default_rng(seed), n_views, 0.5,
                       [4 * H, 4 * W, 3.2 * W]))
    return d


def write_depth_maps(root, n=2, size=(1600, 1200), seed=0):
    """``n`` PFM depth maps of DTU's size (width x height) under ``root``,
    for LLFF's ``depth_path``. Returns the directory."""
    d = Path(root)
    for i in range(n):
        rng = np.random.default_rng([seed, i])
        write_pfm(d / f"depth_map_{i:04d}.pfm",
                  rng.uniform(425.0, 900.0, size[::-1]).astype(np.float32))
    return d


def write_dtu_config(config_dir, scans=("scan1",), n_views=12, n_src=10):
    """A DTU ``config_dir``: ``dtu_pairs.txt`` (each of ``n_views`` views
    paired with the next ``n_src``) and ``lists/dtu_{train,val,test}_all.txt``
    naming ``scans``. Returns the directory."""
    d = Path(config_dir)
    (d / "lists").mkdir(parents=True, exist_ok=True)
    lines = [str(n_views)]
    for v in range(n_views):
        src = [(v + k) % n_views for k in range(1, n_src + 1)]
        lines += [str(v), f"{n_src} " + " ".join(f"{s} {100.0 - k:.1f}"
                                                 for k, s in enumerate(src))]
    (d / "dtu_pairs.txt").write_text("\n".join(lines) + "\n")
    for split in ("train", "val", "test"):
        (d / "lists" / f"dtu_{split}_all.txt").write_text("\n".join(scans)
                                                           + "\n")
    return d


def write_dtu_scene(root, scan="scan1", n_views=49, size=(640, 512),
                    lights=(3,), depth_views=(), depth_size=(1600, 1200),
                    seed=0):
    """A DTU scan: ``Cameras/train/*_cam.txt`` of ``n_views`` cameras on an
    arc around the object (intrinsics at 1/4 of ``size``, depth 425 mm +
    192 x 2.5), ``Rectified/<scan>_train/`` (PNG at ``size`` for each view
    and light of ``lights``) and ``Depths/<scan>/`` PFMs of ``depth_size``
    for ``depth_views``. Returns the root."""
    d = Path(root)
    W, H = size
    cams = d / "Cameras" / "train"
    cams.mkdir(parents=True, exist_ok=True)

    def view(v):
        rng = np.random.default_rng([seed, v])
        a = 0.9 * (v / max(n_views - 1, 1) - 0.5)
        c2w = _look([600.0 * np.sin(a), 100.0 * np.cos(3 * a),
                     600.0 * np.cos(a)], target=(0.0, 0.0, 0.0))
        w2c = np.linalg.inv(np.vstack([c2w, [0.0, 0.0, 0.0, 1.0]]))
        # an OpenCV camera: y and z of the look-at camera flipped
        w2c = np.diag([1.0, -1.0, -1.0, 1.0]) @ w2c
        f = 1.15 * W / 4
        intr = np.array([[f, 0, W / 8], [0, f, H / 8], [0, 0, 1]])
        text = ["extrinsic"] + [" ".join(f"{x:.6f}" for x in r) for r in w2c]
        text += ["", "intrinsic"] + [" ".join(f"{x:.6f}" for x in r)
                                     for r in intr]
        text += ["", "425.0 2.5"]
        (cams / f"{v:08d}_cam.txt").write_text("\n".join(text) + "\n")
        for light in lights:
            _save(d / "Rectified" / f"{scan}_train"
                  / f"rect_{v + 1:03d}_{light}_r5000.png",
                  _pattern(rng, H, W, v + 0.1 * light))
        if v in depth_views:
            write_pfm(d / "Depths" / scan / f"depth_map_{v:04d}.pfm",
                      rng.uniform(425.0, 900.0, depth_size[::-1])
                      .astype(np.float32))

    _each(view, n_views)
    return d


def write_n3dv_scene(root, scene="coffee_martini", n_cams=6, n_frames=2,
                     size=(1352, 1014), seed=0):
    """A Neural 3D Video scene: ``cam00/`` ... one directory of frames per
    camera (JPEG at ``size``, as frames extracted from the videos), and
    ``poses_bounds.npy`` with a row per camera."""
    d = Path(root) / scene
    W, H = size

    def frame(i):
        c, f = divmod(i, n_frames)
        _save(d / f"cam{c:02d}" / f"{f:04d}.jpg",
              _pattern(np.random.default_rng([seed, i]), H, W, 0.5 * c + f))

    _each(frame, n_cams * n_frames)
    np.save(d / "poses_bounds.npy",
            _arc_poses(np.random.default_rng(seed), n_cams, 0.8,
                       [2 * H, 2 * W, 1.4 * W]))
    return d
