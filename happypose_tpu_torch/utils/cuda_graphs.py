"""CUDA graphs of the port's compiled entry points: the counterpart of the
JAX package's jit caches (`inference/pose_estimator.py`: the stage programs
`_coarse_logits_fn` and `_refine_fn`, through which every chunk of pose
updates goes (`forward_refiner`, CosyPose's coarse model),
`forward_coarse_jit`, `run_inference_pipeline_jit`;
`inference/detector.py`: the detector's forward; `training/trainer.py`:
the train step; `training/synth_data.py`: the synthetic batch; the
training scripts' eval forwards).

JAX traces one program per shape key and dispatches it once per call. Here
a `GraphCache` maps a key to a captured callable:

- The first call of a key allocates static input buffers, copies the
  inputs in, runs the function once on a side stream (the warm-up: it
  builds the CUDA kernels, makes cuDNN's and cuBLAS's handles and
  workspaces and fills every lazy cache of the caller, such as an
  estimator's depth refiners), captures it with `torch.cuda.graph` and
  replays the graph.
- Every later call copies its inputs into the static buffers, replays, and
  clones the outputs out, so a returned tensor never aliases a buffer that
  the next replay overwrites.
- All graphs of one cache share one graph memory pool. Captures and
  replays are serial and outputs are cloned at once, so graphs that hold
  intermediates of different sizes (several detection counts) share its
  blocks instead of holding one copy each.

The key is the caller's (JAX's key) plus what a graph bakes in and a jit
does not: PyTorch's two TF32 flags and cuDNN's `deterministic` and
`benchmark` choices, the shapes, dtypes and devices of the inputs, and the identity of the captured objects (models, render assets)
with the storage of every parameter and buffer of the models. Weights
reloaded in place (`load_state_dict`, an optimizer step) are read by the
next replay, as JAX's weights-as-arguments are; parameters replaced by new
tensors (`.to(...)`) make a new key.

On a CUDA tensor a call captures or replays, or raises: it never runs the
function eagerly in the graph's place. On a CPU tensor it takes the same
path with a plain call in place of the graph (static buffers in, clones
out), as `ops.rasterizer_fused.raster_fused` sends a CPU tensor to its
plain version. Called inside another cache's call (its warm-up, its
capture or its CPU plain call) or while any capture is in progress, it
calls the function plainly and counts nothing, so that one graph's
function may call another's: the outer graph records the inner work, as
a jit called inside a jit is inlined. So the refiner's chunk is a graph
of its own when `PoseEstimator.forward_refiner` is called alone (a
tracked frame) and a part of the frame's graph inside
`run_inference_pipeline_jit`.

A training cache (`GraphCache(training=True)`: the train step's, and the
synthetic batch's, whose outputs autograd reads) runs outside inference
mode, so that autograd records: the gradients that a train step
allocates inside the capture (`zero_grad(set_to_none=True)`, forward,
backward, the optimizer's update, all inside `torch.cuda.graph`) come
from the cache's pool, as in PyTorch's whole-network capture. A call
there runs the function once: the first call of a key is the warm-up,
whose results it returns, then the capture, which records the work
without running it, and no replay; every later call is one replay. So a
train step's call is one update.

The kernel's launch count (`ops.rasterizer_fused.launches`) is kept by its
wrapper alone: it counts the warm-up's launches and the capture's (each
records the kernel into the graph), and a replay, which runs no Python,
adds nothing. A replay's launches are counted on the device, from the
kernels `torch.profiler` records (`bench.busy_share`, which also gives the
union of their intervals over the call's wall time).

Each cache has a name (`pipeline`, `stage`, `detector`, `train`, `synth`,
`eval`) and counts, in `utils.profiling`'s counters, its captures (a key's
first call), their seconds and its replays: `graphs.<name>.captures`,
`graphs.<name>.capture_s`, `graphs.<name>.replays` (on the CPU, a key's
first call and its later plain calls). A capture runs under the span
`graphs.capture` and a replay, with the clone of its outputs, under
`graphs.replay`. The stage timings (`profiling.stage`) recorded into a
graph while it is captured are kept with its entry and read after each
replay made while a profiler is active.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Hashable, Iterator, List, Optional, Sequence, Tuple

import torch

from happypose_tpu_torch.utils import profiling


def _leaves(x) -> List[torch.Tensor]:
    """The tensors of a tree of dataclasses, (named) tuples, lists and
    dicts, in a fixed order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [t for f in dataclasses.fields(x) for t in _leaves(getattr(x, f.name))]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    return []


def _map(x, fn: Callable[[torch.Tensor], torch.Tensor]):
    """The same tree with every tensor replaced by `fn(tensor)`."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(
            x, **{f.name: _map(getattr(x, f.name), fn) for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map(v, fn) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_map(v, fn) for v in x)
    if isinstance(x, dict):
        return {k: _map(v, fn) for k, v in x.items()}
    return x


def _spec(x) -> Hashable:
    """The structure of a tree with each tensor's shape, dtype and device,
    and the other leaves as they are."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x), tuple(_spec(getattr(x, f.name)) for f in dataclasses.fields(x)))
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_spec(v) for v in x))
    if isinstance(x, dict):
        return (dict, tuple((k, _spec(v)) for k, v in x.items()))
    return x


def _clone_out(tree):
    """Clones of a tree's tensors; a tensor that appears twice is cloned
    once, so the result shares what the function's output shared."""
    memo: Dict[int, torch.Tensor] = {}

    def clone(t):
        if id(t) not in memo:
            memo[id(t)] = t.clone()
        return memo[id(t)]

    return _map(tree, clone)


def _precision_flags() -> Tuple[bool, bool]:
    """PyTorch's two TF32 flags, which a capture bakes into its kernels."""
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def _algorithm_flags() -> Tuple[bool, bool]:
    """cuDNN's `deterministic` and `benchmark` choices, which pick the
    algorithms a capture bakes in."""
    return torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark


def storage_of(*modules: torch.nn.Module) -> Tuple[int, ...]:
    """The addresses of the modules' parameters and buffers, which a
    capture reads. Read on every graphed call, so the module tree is
    walked directly, at about half the host time of `parameters()` and
    `buffers()`."""
    ptrs, stack = [], list(reversed(modules))
    while stack:
        m = stack.pop()
        for tensors in (m._parameters, m._buffers):
            ptrs.extend(t.data_ptr() for t in tensors.values() if t is not None)
        stack.extend(c for c in reversed(m._modules.values()) if c is not None)
    return tuple(ptrs)


def _is_capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


# `GraphCache` calls running their function (a warm-up, a capture or a CPU
# plain call): a cache called inside one runs its function plainly
_running = 0


@contextlib.contextmanager
def _running_fn() -> Iterator[None]:
    global _running
    _running += 1
    try:
        yield
    finally:
        _running -= 1


@dataclasses.dataclass
class _Entry:
    inputs: List[torch.Tensor]  # the static input buffers, in `_leaves` order
    args: tuple  # the arguments rebuilt on those buffers
    keep: tuple  # the captured objects, kept alive while the entry lives
    graph: Optional[torch.cuda.CUDAGraph] = None
    outputs: object = None  # the graph's static outputs
    capture_s: float = 0.0  # warm-up + capture (+ first replay), seconds
    stages: list = dataclasses.field(default_factory=list)  # `profiling.stage` pairs in the graph


class GraphCache:
    """One captured callable per key (see the module docstring). Not
    thread-safe: captures and replays are serial. `training`: outside
    inference mode, and a call is one run of the function (see the module
    docstring). `name` names its counters."""

    def __init__(self, name: str, training: bool = False):
        self._entries: Dict[tuple, _Entry] = {}
        self._pool = None
        self.name = name
        self.training = training

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def capture_seconds(self) -> List[float]:
        """Seconds of each captured key's first call (warm-up, capture and,
        outside training, the first replay), in the order of capture; 0 for
        CPU entries."""
        return [e.capture_s for e in self._entries.values()]

    def pool_bytes(self) -> int:
        """Bytes the card holds in this cache's graph memory pool."""
        if self._pool is None:
            return 0
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s["segment_pool_id"]) == tuple(self._pool))

    def __call__(self, key: Hashable, fn: Callable, args: tuple,
                 captured: Sequence[object] = ()):
        """`fn(*args)` through the graph of `key`. `captured` are the
        objects `fn` reads besides `args` (models, render assets)."""
        leaves = _leaves(args)
        if not leaves:
            raise ValueError("a graphed call needs at least one tensor argument")
        device = leaves[0].device
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"graphed calls run on CUDA or CPU tensors, not {device}")
        if _running or _is_capturing(device):
            return fn(*args)
        profiling.flush()  # the last traced replay's stage times, before a replay overwrites them
        full_key = (key, tuple(id(o) for o in captured), _precision_flags(), _algorithm_flags(),
                    _spec(args))
        with torch.no_grad() if self.training else torch.inference_mode():
            entry = self._entries.get(full_key)
            new = entry is None
            if new:
                inputs = [torch.empty_like(t) for t in leaves]
                it = iter(inputs)
                entry = _Entry(inputs, _map(args, lambda _: next(it)), tuple(captured))
            for buf, t in zip(entry.inputs, leaves):
                buf.copy_(t)
        with (torch.enable_grad() if self.training else torch.inference_mode(),
              profiling.annotate("graphs.capture" if new else "graphs.replay")):
            if device.type == "cpu":
                with _running_fn():
                    out = fn(*entry.args)
            elif new:
                with torch.cuda.device(device), _running_fn():
                    out = self._capture(entry, fn)
            else:
                entry.graph.replay()
                profiling.replayed(entry.stages)
                out = entry.outputs
            if new:
                self._entries[full_key] = entry
                self._count("capture_s", entry.capture_s)
            self._count("captures" if new else "replays")
            return _clone_out(out)

    def _count(self, what: str, n: float = 1) -> None:
        profiling.count(f"graphs.{self.name}.{what}", n)

    def _capture(self, entry: _Entry, fn: Callable):
        """Warm `fn` up on a side stream, capture it, and return the outputs
        of this call: the first replay's, or in training the warm-up's (the
        capture records the work without running it, so the call runs the
        function once)."""
        t0 = time.perf_counter()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            warm = fn(*entry.args)
        torch.cuda.current_stream().wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with profiling.capturing_stages() as stages, torch.cuda.graph(graph, pool=self._pool):
            outputs = fn(*entry.args)
        if not self.training:
            graph.replay()
        torch.cuda.synchronize()
        entry.graph, entry.outputs, entry.stages = graph, outputs, stages
        entry.capture_s = time.perf_counter() - t0
        return warm if self.training else outputs


_constants: Dict[tuple, torch.Tensor] = {}


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """`torch.tensor(values, dtype=dtype, device=device)`, copied to the
    device at its first use and kept: a capture refuses a host-to-device
    copy (it synchronizes), so a captured function reads the kept tensor.
    `values` is a (nested) tuple of numbers. The tensor is shared: never
    write to it."""
    device = torch.device(device)
    key = (values, dtype, device)
    t = _constants.get(key)
    if t is None:
        if _is_capturing(device):
            raise RuntimeError(f"device_constant {values} first made inside a capture: "
                               "run the function once before capturing it")
        with torch.inference_mode(False):  # usable by autograd outside inference mode
            t = torch.tensor(values, dtype=dtype, device=device)
        _constants[key] = t
    return t
