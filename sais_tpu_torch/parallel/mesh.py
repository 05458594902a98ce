"""Device meshes, batch sharding and the collectives of data-parallel
training.  Counterpart of `sais_tpu/parallel/mesh.py`.

The JAX package shards a batch over a mesh's data axis inside one process
and lets XLA insert the gradient all-reduce.  Here each device is a rank
of a torch.distributed process group (NCCL on the card, gloo on the
CPU), and a mesh is a `DeviceMesh` over those ranks with JAX's axis names:
("data", "model"), ("dcn", "data", "model") over hosts
(`distributed.multislice_mesh`) or ("data", "seq") (`sequence.seq_mesh`).
A rank holds the contiguous block of the padded batch that JAX's
sharding gives its device, in JAX's row order over (dcn, data) jointly.

Training follows one convention, which makes every step equal to the one
over the whole batch (JAX's psum semantics):

- each rank computes the loss over the whole (padded) batch from global
  sums (`all_sum`: the loss's numerator and the weight sum), so every rank
  holds the same loss value, and back-propagates loss / N, N the number
  of ranks in the mesh;
- each collective's backward is the transpose of a sum: `all_sum`'s is an
  all-reduce of the cotangent, `all_gather`'s a reduce-scatter;
- `all_reduce_grads` then sums every parameter's gradient over the ranks
  in one flat buffer, in the optimizer's parameter order.

A plain DistributedDataParallel would average the ranks' local means,
which is wrong on a ragged last batch (the padded rows carry weight 0).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, NamedTuple, \
    Optional, Sequence, Tuple

import numpy as np
import torch

from sais_tpu_torch.config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"
BATCH_AXES = (DCN_AXIS, DATA_AXIS)


def _dist():
    import torch.distributed as dist
    return dist


def device_type() -> str:
    """"cuda" under NCCL, else "cpu" (gloo)."""
    return "cuda" if _dist().get_backend() == "nccl" else "cpu"


def mesh_from_ranks(ranks: np.ndarray, names: Sequence[str]):
    """A DeviceMesh over an array of global ranks, its axes named."""
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type(), torch.as_tensor(np.asarray(ranks)),
                      mesh_dim_names=tuple(names))


def make_mesh(cfg: MeshConfig = MeshConfig(),
              ranks: Optional[Sequence[int]] = None):
    """(data, model) mesh over `ranks` (default: every rank of the group),
    model-major inside a data row as in JAX's reshape."""
    ranks = list(range(_dist().get_world_size()) if ranks is None
                 else ranks)
    n = len(ranks)
    model = max(cfg.model_parallel, 1)
    data = cfg.data_parallel if cfg.data_parallel > 0 else n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return mesh_from_ranks(np.asarray(ranks).reshape(data, model),
                           (DATA_AXIS, MODEL_AXIS))


def axis_size(mesh, name: str) -> int:
    names = mesh.mesh_dim_names
    return mesh.shape[names.index(name)] if name in names else 1


def mesh_size(mesh) -> int:
    """Ranks in the mesh: the N of `loss / N`."""
    return int(mesh.mesh.numel())


def data_parallel_size(mesh) -> int:
    """Number of data-parallel shards (incl. the DCN axis when present)."""
    return axis_size(mesh, DATA_AXIS) * axis_size(mesh, DCN_AXIS)


class BatchSharding(NamedTuple):
    """This rank's block of a batch: block `index` of `count` equal
    contiguous blocks (JAX's P((dcn, data)) on the leading axis)."""

    index: int
    count: int

    def rows(self, n: int) -> slice:
        if n % self.count:
            raise ValueError(f"a leading axis of {n} does not divide over "
                             f"{self.count} shards; pad it first "
                             "(pad_to_multiple)")
        per = n // self.count
        return slice(self.index * per, (self.index + 1) * per)


def data_sharding(mesh) -> BatchSharding:
    """The leading (batch) axis split over the data axis, jointly with the
    DCN axis on multi-host meshes: a host holds a contiguous block."""
    names = mesh.mesh_dim_names
    coord = dict(zip(names, mesh.get_coordinate()))
    index = coord.get(DCN_AXIS, 0) * axis_size(mesh, DATA_AXIS) \
        + coord.get(DATA_AXIS, 0)
    return BatchSharding(index, data_parallel_size(mesh))


def _tree_map(fn: Callable, tree: Any) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch: Any, mesh) -> Any:
    """This rank's block of every array in a batch pytree (numpy arrays or
    tensors), its leading axis split as `data_sharding` says."""
    sh = data_sharding(mesh)
    return _tree_map(lambda x: x[sh.rows(x.shape[0])], batch)


def pad_to_multiple(batch: Any, multiple: int) -> Any:
    """Zero-pad leading axes up to a multiple of the data-axis size so
    shapes divide evenly across ranks (host-side, numpy)."""

    def _pad(x):
        n = x.shape[0]
        rem = (-n) % multiple
        if rem == 0:
            return x
        pad_width = [(0, rem)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(np.asarray(x), pad_width)

    return _tree_map(_pad, batch)


def pad_batch_with_weight(batch: dict, multiple: int) -> dict:
    """Pad a batch dict to a divisible leading size and attach a 'weight'
    array (1.0 for real rows, 0.0 for padding) so losses can mask the
    padded rows out."""
    n = next(iter(batch.values())).shape[0]
    weight = batch.get("weight")
    if weight is None:
        weight = np.ones((n,), np.float32)
    out = dict(batch)
    out["weight"] = weight
    return pad_to_multiple(out, multiple)


def _root(mesh) -> int:
    return int(mesh.mesh.reshape(-1)[0])


def replicate(tree: Any, mesh) -> Any:
    """Broadcast every tensor of a module, tensor or pytree of tensors in
    place from the mesh's first rank (JAX's replicated placement: every
    rank then starts from rank 0's values).  Returns `tree`."""
    dist = _dist()
    src = _root(mesh)

    def bcast(t):
        if isinstance(t, torch.Tensor):
            with torch.no_grad():
                dist.broadcast(t.data, src)
        return t

    if isinstance(tree, torch.nn.Module):
        for t in [*tree.parameters(), *tree.buffers()]:
            bcast(t)
        return tree
    _tree_map(bcast, tree)
    return tree


def broadcast_object(obj: Any, mesh=None) -> Any:
    """A picklable object from the first rank (rank 0 without a mesh) to
    every rank."""
    dist = _dist()
    box = [obj]
    dist.broadcast_object_list(box, src=0 if mesh is None else _root(mesh))
    return box[0]


# -- groups ------------------------------------------------------------------

_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Tuple[Any, Any]] = {}


def axis_group(mesh, axes: Iterable[str]):
    """The process group of this rank's fellows along `axes` jointly (the
    ranks that share every other coordinate).  Every rank of the world
    makes every such group, in one order (torch.distributed.new_group's
    rule); the result is cached per mesh."""
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(a for a in names if a in tuple(axes))
    key = (id(mesh), axes)
    if key in _GROUPS:
        return _GROUPS[key][1]
    dist = _dist()
    arr = mesh.mesh.numpy()
    inner = [names.index(a) for a in axes]
    outer = [i for i in range(len(names)) if i not in inner]
    cols = np.transpose(arr, outer + inner).reshape(
        -1, int(np.prod([arr.shape[i] for i in inner], dtype=int)))
    me, world = dist.get_rank(), dist.get_world_size()
    mine = None
    for col in cols:
        ranks = [int(r) for r in col]
        group = (dist.group.WORLD if len(ranks) == world
                 else dist.new_group(ranks))
        if me in ranks:
            mine = group
    _GROUPS[key] = (mesh, mine)
    return mine


def batch_group(mesh):
    """The ranks that hold the shards of one batch: (dcn, data)."""
    return axis_group(mesh, BATCH_AXES)


# -- differentiable collectives ------------------------------------------------

class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        _dist().all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        _dist().all_reduce(g, group=ctx.group)
        return g, None


def all_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of x over the group's ranks, on every rank (psum); its backward
    all-reduces the cotangent (module docstring)."""
    return _AllSum.apply(x, group)


def _group_size(group) -> int:
    return _dist().get_world_size(group)


def _group_rank(group) -> int:
    return _dist().get_rank(group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(_group_size(group))]
        _dist().all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        _dist().all_reduce(g, group=ctx.group)
        n, i = _group_size(ctx.group), _group_rank(ctx.group)
        return g.chunk(n, ctx.dim)[i], None, None


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's x (equal shapes) concatenated along `dim` in group-rank
    order, on every rank; its backward is a reduce-scatter."""
    return _AllGather.apply(x, group, dim)


def all_reduce_grads(params: Sequence[torch.nn.Parameter],
                     group=None) -> None:
    """Sum each parameter's .grad over the group in one flat f32 buffer, in
    the order given (fixed: the optimizer's).  A parameter the loss did
    not reach contributes zeros and gets a zero gradient, as in JAX."""
    params = list(params)
    if not params:
        return
    flat = torch.cat([
        (torch.zeros_like(p, dtype=torch.float32) if p.grad is None
         else p.grad.float()).reshape(-1) for p in params])
    _dist().all_reduce(flat, group=group)
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = flat[offset:offset + n].view(p.shape).to(p.dtype)
        offset += n


class DataParallel:
    """A trainer's view of its mesh: `mesh` is the training mesh (N ranks,
    `loss / N`), `batch_mesh` the one whose (dcn, data) axes shard the
    batches (None: every rank reads the whole batch, as on a pure 'seq'
    mesh).  One rule for every trainer (module docstring)."""

    def __init__(self, mesh, batch_mesh=None):
        self.mesh, self.batch_mesh = mesh, batch_mesh
        self.n = mesh_size(mesh)
        self.shards = (data_parallel_size(batch_mesh)
                       if batch_mesh is not None else 1)
        self.group = batch_group(batch_mesh) if batch_mesh is not None \
            else None

    def shard(self, batch: dict) -> dict:
        """A host batch padded with its 'weight' rows and cut to this
        rank's block (JAX's pad_batch_with_weight + shard_batch)."""
        if self.batch_mesh is None:
            return batch
        return shard_batch(pad_batch_with_weight(batch, self.shards),
                           self.batch_mesh)

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """A sum over this rank's rows -> the sum over the batch's."""
        return x if self.group is None else all_sum(x, self.group)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows -> the whole padded batch's, in order."""
        return x if self.group is None else all_gather(x, self.group)

    def backward(self, loss: torch.Tensor,
                 params: Sequence[torch.nn.Parameter]) -> None:
        """loss / N backward, then the gradients summed over the ranks."""
        (loss / self.n).backward()
        all_reduce_grads(params)


def row_blocks(xs: Sequence[torch.Tensor], mesh
               ) -> Tuple[List[List[torch.Tensor]], int]:
    """Every rank's block of the rows of xs (rows zero-padded to a multiple
    of the mesh's ranks; blocks in rank order over every axis jointly,
    JAX's P(tuple(mesh.axis_names))) -> (blocks, the rows of xs):
    blocks[r] holds rank r's block of each x."""
    n = mesh_size(mesh)
    rows = xs[0].shape[0]
    pad = (-rows) % n
    if pad:
        xs = [torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
              for x in xs]
    per = (rows + pad) // n
    return [[x[r * per:(r + 1) * per] for x in xs] for r in range(n)], rows


def mesh_rank(mesh) -> int:
    """This rank's index in the mesh's rank order (every axis jointly)."""
    return _group_rank(axis_group(mesh, mesh.mesh_dim_names))


def gather_rows(y: torch.Tensor, mesh, rows: int) -> torch.Tensor:
    """Every rank's block of outputs, in rank order, cut to `rows`."""
    group = axis_group(mesh, mesh.mesh_dim_names)
    return all_gather(y.contiguous(), group)[:rows]
