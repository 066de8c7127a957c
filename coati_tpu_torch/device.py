"""Device selection (counterpart of coati_tpu.align.engine._devices_for).

resolve_device gives one device; resolve_devices a list of lanes, the queues
the engine spreads its chunks over: each a device and, where several lanes
run on cards, a CUDA stream of its own. A list may name a device more than
once, so two lanes can share one card (two streams) or the CPU (two turns).
Asking for CUDA where there is none is an error: no code path moves to the
CPU on its own. Also each lane's host memory for the copies between host
and device that the engine overlaps with its kernels (Staging).
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """The torch.device for `name` ("cuda", "cuda:N" or "cpu").

    Raises RuntimeError when CUDA is asked for and torch.cuda.is_available()
    is False."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(name)!r} requested but CUDA is not available; "
            "pass --device cpu (device='cpu') to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(name)!r}")
    return dev


class Lane:
    """One queue of work: a device and, on a card when a run has several
    lanes, a CUDA stream of its own (None: the device's current stream).
    `chunks` counts the chunks and long-pair groups the engine has enqueued
    on it; `staging` is its host memory for copies (Staging)."""

    __slots__ = ("device", "stream", "chunks", "staging")

    def __init__(self, device: torch.device, stream=None):
        self.device = device
        self.stream = stream
        self.chunks = 0
        self.staging = Staging(device)

    def __repr__(self) -> str:
        return f"Lane({self.device}, stream={'own' if self.stream else 'current'})"

    def context(self):
        """Make this lane's card and stream current for the work enqueued
        inside (every kernel wrapper launches on the current stream)."""
        if self.stream is not None:
            return torch.cuda.stream(self.stream)
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def share(self, *tensors) -> None:
        """Order this lane's stream after what the current stream of its
        device has enqueued so far, and mark `tensors`, written there, as in
        use by the lane, so that the caching allocator does not hand their
        memory out again before the lane's work on them is done."""
        if self.stream is None:
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        for t in tensors:
            t.record_stream(self.stream)


def resolve_devices(spec="cuda") -> list[Lane]:
    """The lanes for `spec`: a name or torch.device, a list of them, or a
    list of Lanes (returned as they are, so their streams and counts carry
    over between calls).

    "cuda" means every local card, capped by COATI_TPU_MAX_DEVICES as the
    JAX package caps its devices; "cuda:N" that card; "cpu" one CPU lane.
    Each entry of a list is a lane of its own, a repeated one too. One lane
    runs on its device's current stream; with several, each lane on a card
    gets a stream of its own. Raises as resolve_device does."""
    if isinstance(spec, Lane):
        return [spec]
    items = [spec] if isinstance(spec, (str, torch.device)) else list(spec)
    if items and all(isinstance(x, Lane) for x in items):
        return items
    devs = []
    for item in items:
        if isinstance(item, Lane):
            raise TypeError("give lanes or device names, not both")
        dev = resolve_device(item)
        if dev.type == "cuda" and dev.index is None:
            n = torch.cuda.device_count()
            cap = int(os.environ.get("COATI_TPU_MAX_DEVICES", "0"))
            devs += [torch.device("cuda", q) for q in range(min(n, cap) if cap > 0 else n)]
        else:
            devs.append(dev)
    if not devs:
        raise ValueError("no device given")
    if len(devs) == 1:
        return [Lane(devs[0])]
    return [Lane(d, torch.cuda.Stream(device=d) if d.type == "cuda" else None)
            for d in devs]


def lane_of(spec="cuda") -> Lane:
    """A Lane as it is; else a lane on resolve_device(spec), on its device's
    current stream."""
    return spec if isinstance(spec, Lane) else Lane(resolve_device(spec))


# upload slots a lane cycles through. A slot is filled again only once the
# card has copied it, and a chunk's copy waits in the lane's stream behind
# the kernels of the chunk before, so the host waits on a kernel only when
# the card is UPLOAD_SLOTS chunks behind it (a chunk's kernels take a tenth
# of the host's time to pad and enqueue it on the main path)
UPLOAD_SLOTS = 3
ALIGN = 256  # bytes: where each staged array starts in its buffer


def _layout(specs):
    """([(offset, bytes, shape, numpy dtype), ...], bytes in all) of arrays
    of the (shape, dtype) specs laid out in one buffer, each at a multiple
    of ALIGN."""
    out, end = [], 0
    for shape, dtype in specs:
        dtype = np.dtype(dtype)
        shape = tuple(int(n) for n in shape)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        out.append((end, nbytes, shape, dtype))
        end += -(-nbytes // ALIGN) * ALIGN
    return out, end


def _views(flat, layout):
    """Arrays of `layout` over `flat`, a numpy uint8 buffer."""
    return [flat[o:o + n].view(dt).reshape(shape) for o, n, shape, dt in layout]


class _Slot:
    """One host buffer of a Staging: pinned memory on a card (a uint8
    tensor and its numpy view), the event after its last copy, and for a
    download slot whether a reader holds it."""

    __slots__ = ("host", "flat", "event", "busy")

    def __init__(self):
        self.host = self.flat = self.event = None
        self.busy = False

    def grow(self, nbytes: int, pinned: bool) -> np.ndarray:
        """The numpy view of at least nbytes, allocated anew only when the
        buffer is smaller."""
        if self.host is None or self.host.numel() < nbytes:
            self.host = torch.empty(max(nbytes, ALIGN), dtype=torch.uint8,
                                    pin_memory=pinned)
            self.flat = self.host.numpy()
        return self.flat


class Fetch:
    """Results on their way to a lane's host memory (Staging.fetch).
    `with fetch as arrays:` waits for the copies and gives the numpy arrays,
    which are the lane's buffer until the block ends: read or copy them
    inside it."""

    def __init__(self, arrays, event=None, slot=None):
        self.arrays, self.event, self.slot = arrays, event, slot

    def __enter__(self):
        if self.event is not None:
            self.event.synchronize()
        return self.arrays

    def __exit__(self, *exc):
        if self.slot is not None:
            self.slot.busy = False


class Staging:
    """The host memory of one lane's copies, reused from chunk to chunk: on
    a card pinned buffers, allocated once and grown only when a chunk needs
    more; on the CPU ordinary memory that the plain kernels read in place.
    The host writes a chunk's inputs straight into an upload slot's views,
    one copy sends the slot to the device, and results come back into a
    download slot. No CPU tensor operation runs, so the copies never enter
    PyTorch's CPU thread pool.

    Uploads: stage() hands out views of the next of UPLOAD_SLOTS slots,
    waiting first for the card to finish the slot's last copy; send()
    copies them. Downloads: fetch() copies into a slot that no reader holds
    (a new one when every slot is held)."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.pinned = self.device.type == "cuda"
        self.uploads = [_Slot() for _ in range(UPLOAD_SLOTS)]
        self.downloads: list[_Slot] = []
        self._turn = 0
        self._staged = None

    def stage(self, *specs) -> list[np.ndarray]:
        """Numpy arrays of the (shape, dtype) specs for the host to fill,
        views of the next upload slot; send() copies them."""
        slot = self.uploads[self._turn]
        self._turn = (self._turn + 1) % len(self.uploads)
        if slot.event is not None:
            slot.event.synchronize()
            slot.event = None
        layout, nbytes = _layout(specs)
        arrays = _views(slot.grow(nbytes, self.pinned), layout)
        self._staged = (slot, layout, nbytes, arrays)
        return arrays

    def send(self) -> list[torch.Tensor]:
        """The arrays of the last stage() on the device, in their order: on a
        card views of one device buffer, filled by one copy on the current
        stream that nothing waits for; on the CPU the arrays themselves."""
        slot, layout, nbytes, arrays = self._staged
        self._staged = None
        if not self.pinned:
            return [torch.from_numpy(a) for a in arrays]
        on_dev = slot.host[:nbytes].to(self.device, non_blocking=True)
        slot.event = torch.cuda.Event()
        slot.event.record(torch.cuda.current_stream(self.device))
        return [on_dev[o:o + n].view(_TORCH_DTYPES[dt]).view(shape)
                for o, n, shape, dt in layout]

    def _download_slot(self) -> _Slot:
        """A download slot that no reader holds; a new one when every slot
        is held."""
        slot = next((s for s in self.downloads if not s.busy), None)
        if slot is None:
            slot = _Slot()
            self.downloads.append(slot)
        return slot

    def fetch(self, *tensors) -> Fetch:
        """Start copying `tensors` from the device into a download slot, on
        the current stream, without waiting; on the CPU they are read in
        place."""
        if not self.pinned:
            return Fetch([t.numpy() for t in tensors])
        with torch.profiler.record_function("download"):
            slot = self._download_slot()
            layout, nbytes = _layout((t.shape, _NUMPY_DTYPES[t.dtype])
                                     for t in tensors)
            arrays = _views(slot.grow(nbytes, True), layout)
            for t, (o, n, _, _) in zip(tensors, layout):
                slot.host[o:o + n].view(t.dtype).view(t.shape).copy_(t, non_blocking=True)
            slot.event = torch.cuda.Event()
            slot.event.record(torch.cuda.current_stream(tensors[0].device))
            slot.busy = True
            return Fetch(arrays, slot.event, slot)


_TORCH_DTYPES = {np.dtype(n): t for n, t in (
    ("int8", torch.int8), ("uint8", torch.uint8), ("int32", torch.int32),
    ("int64", torch.int64), ("float32", torch.float32))}
_NUMPY_DTYPES = {t: n for n, t in _TORCH_DTYPES.items()}


def host_arrays(staging: Staging | None, *specs) -> list[np.ndarray]:
    """Arrays of the (shape, dtype) specs to fill: views of staging's next
    upload slot (Staging.stage), or new arrays when staging is None."""
    if staging is not None:
        return staging.stage(*specs)
    return [np.empty(shape, dtype) for shape, dtype in specs]


def fill_rows(out: np.ndarray, seqs) -> np.ndarray:
    """Write ragged sequences into the rows of `out` [B, N], in one pass:
    row p holds seqs[p] and zeros after it (the host reads every cell: the
    code checks, the triplet path's insertion offsets). Returns the lengths,
    [B] int32."""
    lens = np.fromiter(map(len, seqs), np.int32, count=len(seqs))
    if len(seqs):
        out[:, int(lens.min()):] = 0
        for row, s in zip(out, seqs):
            row[:len(s)] = s
    return lens
