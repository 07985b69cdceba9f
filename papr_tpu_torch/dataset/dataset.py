"""Ray-image dataset and host-side loader (``papr_tpu/dataset/dataset.py``).

Behavioral spec: reference dataset/dataset.py (``RINDataset``) and
dataset/utils.py:99-118 (``extract_patches``). As in the JAX package there
is no torch DataLoader: a numpy pipeline assembles ``Batch`` structs on the
host (the same seeds give the same batches in both packages) and
``device_prefetch`` overlaps the host-to-device copies with device compute.

Batch item layout matches the reference 5-tuple
``(img_idx, patch_idx, image, rayd, rayo)`` plus the per-image ``c2w`` so the
training step never does host lookups.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops.geometry import get_rays_np
from .loaders import composite_background, load_meta_data


@dataclass
class Batch:
    img_idx: np.ndarray   # (B,)
    patch_idx: np.ndarray  # (B,)
    image: np.ndarray     # (B, h, w, 3)
    rayd: np.ndarray      # (B, h, w, 3)
    rayo: np.ndarray      # (B, 3)
    c2w: np.ndarray       # (B, 4, 4)


class RINDataset:
    """Per-image random patches of (target RGB, ray dirs, ray origin)."""

    def __init__(self, args, mode: str = "train", seed: int = 0):
        self.args = args
        images, c2w, H, W, fx, fy, paths = load_meta_data(args, mode=mode)
        coord_scale = float(args.coord_scale)
        if coord_scale != 1:
            scaling = np.diag([coord_scale] * 3 + [1.0]).astype(np.float32)
            c2w = np.einsum("ij,njk->nik", scaling, c2w)

        self.num_imgs = len(paths)
        self.H, self.W = int(H), int(W)
        self.focal_x, self.focal_y = float(fx), float(fy)
        self.c2w = c2w.astype(np.float32)
        self.image_paths = paths
        self.images = images if args.read_offline else images[:1]
        # Patch sampling is deterministic under the config seed, like the
        # reference's global setup_seed (utils.py:42-45 feeding the
        # np.random.randint crops in dataset/utils.py:110-111).
        self._rng = np.random.default_rng(seed)
        self._img_cache: dict = {}

        if args.read_offline:
            self.rayo, self.rayd = get_rays_np(self.H, self.W, fx, fy, c2w)

        self._offline_patches = None
        if args.extract_patch and not args.extract_online and args.read_offline:
            self._offline_patches = extract_patches(
                self.images, self.rayo, self.rayd, args, self._rng)

    # ------------------------------------------------------------- access --

    def _read_image(self, idx: int):
        """Lazy decode + per-image rays (reference dataset/dataset.py:50-67).

        Decoded images and ray grids are LRU-cached (`dataset.cache_images`
        entries, default 256) — the reference re-decodes the PNG every
        access, which starves fast devices.
        """
        cached = self._img_cache.get(idx)
        if cached is not None:
            self._img_cache[idx] = self._img_cache.pop(idx)  # refresh LRU
            return cached
        from PIL import Image
        img = Image.open(self.image_paths[idx]).resize((self.W, self.H))
        img = (np.asarray(img) / 255.0).astype(np.float32)
        img = composite_background(img[None], self.args.white_bg)[0]
        rayo, rayd = get_rays_np(self.H, self.W, self.focal_x, self.focal_y,
                                 self.c2w[idx:idx + 1])
        limit = int(self.args.get("cache_images", 256) or 0)
        if limit > 0:
            if len(self._img_cache) >= limit:
                self._img_cache.pop(next(iter(self._img_cache)))
            self._img_cache[idx] = (img, rayo, rayd)
        return img, rayo, rayd

    def __len__(self) -> int:
        if self._offline_patches is not None:
            return self.num_imgs * self._offline_patches[3]
        return self.num_imgs

    def __getitem__(self, idx: int):
        """Returns the reference 5-tuple (img_idx, patch_idx, img, rayd, rayo)."""
        a = self.args
        if self._offline_patches is not None:
            imgs, rayds, rayos, n_patches = self._offline_patches
            img_idx, patch_idx = divmod(idx, n_patches)
            return (img_idx, patch_idx, imgs[img_idx, patch_idx],
                    rayds[img_idx, patch_idx], rayos[img_idx, patch_idx])
        if a.extract_patch and a.extract_online:
            if a.read_offline:
                img = self.images[idx:idx + 1]
                rayo, rayd = self.rayo[idx:idx + 1], self.rayd[idx:idx + 1]
            else:
                image, rayo, rayd = self._read_image(idx)
                img = image[None]
            imgs, rayds, rayos, _ = extract_patches(
                img, rayo, rayd, a, self._rng, max_patches=1)
            return idx, 0, imgs[0, 0], rayds[0, 0], rayos[0, 0]
        if a.read_offline:
            return idx, 0, self.images[idx], self.rayd[idx], self.rayo[idx]
        image, rayo, rayd = self._read_image(idx)
        return idx, 0, image, rayd[0], rayo[0]

    def get_full_img(self, img_idx: int):
        if self.args.read_offline:
            return (self.images[img_idx][None], self.rayd[img_idx][None],
                    self.rayo[img_idx][None])
        image, rayo, rayd = self._read_image(img_idx)
        return image[None], rayd, rayo

    def get_c2w(self, img_idx: int) -> np.ndarray:
        return self.c2w[img_idx]

    def get_new_rays(self, c2w: np.ndarray):
        return get_rays_np(self.H, self.W, self.focal_x, self.focal_y, c2w)


def extract_patches(imgs, rays_o, rays_d, args, rng: np.random.Generator,
                    max_patches: int | None = None):
    """Uniform random patch crops (reference dataset/utils.py:99-118)."""
    popt = args.patches
    N, H, W, C = imgs.shape
    ph, pw = int(popt.height), int(popt.width)
    n = int(max_patches if max_patches is not None else popt.max_patches)
    img_p = np.zeros((N, n, ph, pw, C), np.float32)
    rayd_p = np.zeros((N, n, ph, pw, 3), np.float32)
    rayo_p = np.zeros((N, n, 3), np.float32)
    for i in range(N):
        for j in range(n):
            y0 = rng.integers(0, H - ph)
            x0 = rng.integers(0, W - pw)
            img_p[i, j] = imgs[i, y0:y0 + ph, x0:x0 + pw]
            rayd_p[i, j] = rays_d[i, y0:y0 + ph, x0:x0 + pw]
            rayo_p[i, j] = rays_o[i]
    return img_p, rayd_p, rayo_p, n


class Loader:
    """Shuffling batch iterator with background prefetch.

    Replaces torch DataLoader (reference dataset/__init__.py:9-18): batches
    are host numpy ``Batch`` structs; a worker thread keeps ``prefetch``
    batches ready so patch extraction overlaps device compute.
    """

    def __init__(self, dataset: RINDataset, batch_size: int = 1,
                 shuffle: bool = True, seed: int = 0, prefetch: int = 2,
                 drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self._prefetch = prefetch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _epoch_batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        stop = len(order) - (len(order) % bs) if self.drop_last else len(order)
        for s in range(0, stop, bs):
            items = [self.dataset[int(i)] for i in order[s:s + bs]]
            img_idx = np.array([it[0] for it in items], np.int32)
            yield Batch(
                img_idx=img_idx,
                patch_idx=np.array([it[1] for it in items], np.int32),
                image=np.stack([it[2] for it in items]),
                rayd=np.stack([it[3] for it in items]),
                rayo=np.stack([it[4] for it in items]),
                c2w=np.stack([self.dataset.get_c2w(int(i)) for i in img_idx]),
            )

    def __iter__(self):
        if self._prefetch <= 0:
            yield from self._epoch_batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self._prefetch)
        SENTINEL = object()

        def worker():
            try:
                for b in self._epoch_batches():
                    q.put(b)
            finally:
                q.put(SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is SENTINEL:
                break
            yield item


def device_prefetch(loader, depth: int = 2, device=None):
    """Wrap a Batch iterator so host-to-device copies overlap compute.

    Each batch's arrays become pinned host tensors copied to ``device``
    (``None``: the card) with ``non_blocking=True``; ``depth`` batches are in
    flight. A batch's pinned tensors stay referenced until the consumer asks
    for the next batch, i.e. until the step that consumes it has been
    enqueued. On the CPU the tensors are handed over as they are.
    """
    import collections

    dev = resolve_device(device)
    pin = dev.type == "cuda"

    def to_device(b: Batch):
        host = {}
        for name in ("image", "rayd", "rayo", "c2w"):
            t = torch.from_numpy(np.ascontiguousarray(getattr(b, name)))
            host[name] = t.pin_memory() if pin else t
        moved = {n: t.to(dev, non_blocking=True) for n, t in host.items()}
        return Batch(img_idx=b.img_idx, patch_idx=b.patch_idx, **moved), host

    pending = collections.deque()
    it = iter(loader)
    try:
        for _ in range(depth):
            pending.append(to_device(next(it)))
    except StopIteration:
        pass
    while pending:
        out, host = pending.popleft()
        try:
            pending.append(to_device(next(it)))
        except StopIteration:
            pass
        yield out
        del host          # the consuming step has been enqueued by now


def get_dataset(dataset_args, mode: str = "train", seed: int = 0) -> RINDataset:
    return RINDataset(dataset_args, mode=mode, seed=seed)


def get_loader(dataset: RINDataset, dataset_args, mode: str = "train") -> Loader:
    if mode == "train":
        return Loader(dataset, batch_size=dataset_args.batch_size,
                      shuffle=dataset_args.shuffle)
    return Loader(dataset, batch_size=1, shuffle=False)
