"""Dataset protocol, frame decode, subset and prefetch wrappers (port of
``align3d_tpu/io/datasets/core.py``; reference ``src/io/dataset/core.rs``).

Frames decode on the host: through the native library
(:mod:`align3d_torch.io.native_loader`) when it is built, else PNG through
:mod:`align3d_torch.io.png` and JPEG through Pillow where Pillow imports.
Every route is lossless for PNG, so each gives the same pixels.
"""

from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import numpy as np

from align3d_torch.camera import CameraIntrinsics
from align3d_torch.image import RgbdFrame, RgbdImage
from align3d_torch.io import native_loader, png
from align3d_torch.se3 import Transform
from align3d_torch.trajectory import Trajectory


class DatasetError(Exception):
    pass


@runtime_checkable
class RgbdDataset(Protocol):
    """The reference trait (core.rs:47-53)."""

    def __len__(self) -> int: ...

    def get(self, index: int) -> RgbdFrame: ...

    def trajectory(self) -> Trajectory | None: ...

    def camera(self, index: int) -> tuple[CameraIntrinsics, Transform | None]: ...


class SubsetDataset:
    """Index-remapping wrapper with trajectory re-indexing (core.rs:55-93)."""

    def __init__(self, dataset: RgbdDataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def get(self, index: int) -> RgbdFrame:
        return self.dataset.get(self.indices[index])

    def trajectory(self) -> Trajectory | None:
        orig = self.dataset.trajectory()
        if orig is None:
            return None
        poses = [orig.camera_to_world[i] for i in self.indices]
        return Trajectory.from_list(poses, np.arange(len(poses), dtype=np.float32))

    def camera(self, index: int):
        return self.dataset.camera(self.indices[index])


def _pil_image(path: str):
    """Open ``path`` with Pillow, or raise DatasetError naming both decoders."""
    try:
        from PIL import Image
    except ImportError:
        raise DatasetError(
            f"cannot decode {path}: the native loader is unavailable "
            f"({native_loader.unavailable_reason()}) and Pillow is not installed"
        ) from None
    return Image.open(path)


def load_rgb(path) -> np.ndarray:
    """Decode a colour frame (PNG or JPEG) into (H, W, 3) u8."""
    path = str(path)
    if native_loader.available():
        try:
            return native_loader.decode_rgb(path)
        except IOError:
            pass  # a format libpng/libjpeg refuse: try the others
    if path.lower().endswith(".png"):
        try:
            image = png.read(path)
        except png.PngError:
            image = None
        if image is not None and image.ndim == 3:
            return image
    return np.asarray(_pil_image(path).convert("RGB"), dtype=np.uint8)


def load_depth_u16(path) -> np.ndarray:
    """Decode a depth frame (a grayscale PNG) into (H, W) u16."""
    path = str(path)
    if path.lower().endswith(".png"):
        if native_loader.available():
            try:
                return native_loader.decode_depth(path)
            except IOError:
                pass
        try:
            image = png.read(path)
        except png.PngError:
            image = None
        if image is not None and image.ndim == 2:
            return image
    arr = np.asarray(_pil_image(path))
    if arr.dtype == np.uint16:
        return arr
    if arr.dtype in (np.int32, np.uint8):  # Pillow's mode "I" for 16-bit PNG; 8-bit grey
        return arr.astype(np.uint16)
    raise DatasetError(f"unsupported depth dtype {arr.dtype} for {path}")


class PrefetchingDataset:
    """A dataset that exposes its frames' paths, decoded ahead by the native
    worker pool (:class:`native_loader.PrefetchLoader`): the host decodes
    the next frames while the device aligns this one. Camera, pose and
    depth scale still come from the wrapped dataset. It owns the pool:
    :meth:`close` it when the run ends. :func:`maybe_prefetch` wraps only
    where the library is built and the dataset has ``frame_paths()``."""

    def __init__(self, dataset, n_threads: int = 4, prefetch: int = 8):
        colors, depths = dataset.frame_paths()
        self.dataset = dataset
        self.loader = native_loader.PrefetchLoader(colors, depths, n_threads=n_threads, prefetch=prefetch)

    def __len__(self) -> int:
        return len(self.dataset)

    def get(self, index: int) -> RgbdFrame:
        meta = self.dataset.get_meta(index) if hasattr(self.dataset, "get_meta") else None
        color, depth = self.loader.get(index)
        if meta is None:
            # The wrapped dataset assembles the frame; the images are swapped.
            frame = self.dataset.get(index)
            return RgbdFrame(
                camera=frame.camera,
                image=RgbdImage(color, depth, frame.image.depth_scale),
                camera_to_world=frame.camera_to_world,
            )
        camera, pose, depth_scale = meta
        return RgbdFrame(camera=camera, image=RgbdImage(color, depth, depth_scale), camera_to_world=pose)

    def trajectory(self):
        return self.dataset.trajectory()

    def camera(self, index: int):
        return self.dataset.camera(index)

    def close(self) -> None:
        self.loader.close()


def maybe_prefetch(dataset, n_threads: int = 4, prefetch: int = 8):
    """``dataset`` in a :class:`PrefetchingDataset` when the native library
    is built and the dataset has ``frame_paths()``; else ``dataset`` itself,
    as also when the wrapper fails to start (the JAX package's contract)."""
    if hasattr(dataset, "frame_paths") and native_loader.available():
        try:
            return PrefetchingDataset(dataset, n_threads=n_threads, prefetch=prefetch)
        except Exception:
            return dataset
    return dataset
