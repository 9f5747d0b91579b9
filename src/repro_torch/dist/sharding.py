"""Logical-axis sharding on a torch ``DeviceMesh``: the one place that
knows how model axes map to mesh axes (port of ``repro.dist.sharding``).

Parameters are matched against the ``_PARAM_RULES`` regex table and
logical axis names (``logical("batch", "seq")``) resolve onto whatever
mesh is active:

* no mesh (unit tests, one-card runs) — every call is a no-op;
* host mesh ``(n, 1)`` — specs resolve, the model axis has size 1;
* production meshes ``(16, 16)`` / ``(2, 16, 16)`` — batch spreads over
  ``('pod', 'data')``, the tensor/expert/sequence-parallel axes over
  ``'model'``.

A spec is a :class:`PartitionSpec`, a tuple whose entries are a mesh-axis
name, a tuple of names or ``None``, entry for entry the reference's.
:func:`placements` turns one into DTensor placements: a tuple entry such
as ``("pod", "data")`` shards its dim on both mesh dims, outer axis first,
the block order JAX gives the same entry.

Parameters are placed as DTensors by :func:`param_pspecs`; compute reads
each one gathered whole (:func:`full`, per layer through
:func:`gather_hooks`), since the kernels take no DTensor.  Activations of
a meshed run are plain tensors holding this rank's block of the rows
(``dist.group``): its share of the batch on the data axes and, under the
context-parallel layout (``parallelism="fsdp_cp"``, the dense decoders),
its block of the sequence on ``'model'``, with the keys and values
gathered whole for attention.  At decode the model axis splits the
attention heads instead, the reference's cache layout: each rank keeps
and attends its share of the KV cache (``dist.group.HeadShare``) and
gathers the attention output's heads.  The reference's constraint sites
of those layouts are these moves, made explicitly; :func:`shard` itself
returns its input.  The other tensor-parallel sites on ``'model'`` (the
heads and FFN of a prefill or a train step, experts, mamba channels:
``parallelism="tp"``) have no counterpart yet: there the model axis
repeats compute.

The port keeps one tensor a layer (``layers.{d}.…``), so a per-layer
leaf's spec is the reference's stacked spec without its leading stack
entry: the rules are right-aligned, and ``_drop_indivisible`` runs on the
same trailing dims.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Optional, Sequence

import torch

# data-parallel mesh axes, outermost first ('pod' only exists multi-pod)
_DP_AXES = ("pod", "data")

# logical axis -> mesh axis (str), tuple of mesh axes, or None (replicated)
_DEFAULT_RULES = {
    "batch": _DP_AXES,
    "seq": "model",        # sequence/context parallelism (fsdp_cp)
    "heads": "model",      # attention-head tensor parallelism
    "kv": "model",         # KV-head parallelism (GQA decode)
    "ffn": "model",        # MLP hidden dim
    "vocab": "model",      # vocab-parallel embedding / logits
    "experts": "model",    # MoE expert parallelism
    "inner": "model",      # mamba d_inner channel parallelism
    # raw mesh axis names pass through so rules can name them directly
    "pod": "pod",
    "data": "data",
    "model": "model",
}



class _State(threading.local):
    """The active mesh + resolution rules, the mesh axes over which the
    running forward's rows are split (``dist.group.split_rows``: the data
    axes for the batch, ``'model'`` for the sequence), whether it is in
    a section every model rank runs on the same rows
    (``dist.group.replicated``) and the share of the attention heads a
    decode step holds (``dist.group.split_heads``).  Per thread: ranks
    that share a process (a threaded process group) each keep their
    own."""

    def __init__(self):
        self.d = {"mesh": None, "rules": dict(_DEFAULT_RULES), "split": (),
                  "replicated": False, "heads": None}


class _Active:
    _tls = _State()

    def __getitem__(self, key):
        return self._tls.d[key]

    def __setitem__(self, key, value):
        self._tls.d[key] = value


_ACTIVE = _Active()


class carried:
    """The calling thread's active state (mesh, rules, split axes,
    replicated flag), reinstalled in the thread that enters this: autograd
    runs a CUDA graph's backward, and with it a rematerialised layer's
    recompute, on a device thread of its own, whose state is empty."""

    def __init__(self):
        self._d = dict(_ACTIVE._tls.d)

    def __enter__(self):
        self._prev, _ACTIVE._tls.d = _ACTIVE._tls.d, dict(self._d)
        return self

    def __exit__(self, *exc):
        _ACTIVE._tls.d = self._prev


def _canonical(entry):
    """A tuple of one name is that name, an empty one ``None`` (as JAX
    canonicalises a ``PartitionSpec`` entry)."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


class PartitionSpec(tuple):
    """One spec entry per tensor dim: a mesh-axis name, a tuple of names
    (the dim is split over each, outer first) or ``None`` (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without devices or a process group: enough for
    the spec algebra (a mesh of any size on any host)."""
    shape: tuple
    mesh_dim_names: tuple


def axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names) if mesh is not None else ()


def axis_size(mesh, name: str) -> int:
    return int(mesh.shape[axis_names(mesh).index(name)])


def mesh_str(mesh) -> str:
    return "x".join(str(int(s)) for s in mesh.shape)


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    """Activate ``mesh`` (and optional rule overrides) for
    shard()/logical() calls in the dynamic extent.  Nestable; restores the
    outer context."""
    prev = (_ACTIVE["mesh"], _ACTIVE["rules"])
    merged = dict(_DEFAULT_RULES)
    if rules:
        merged.update(rules)
    _ACTIVE["mesh"] = mesh
    _ACTIVE["rules"] = merged
    try:
        yield mesh
    finally:
        _ACTIVE["mesh"], _ACTIVE["rules"] = prev


def active_mesh():
    return _ACTIVE["mesh"]


def _resolve(axis, mesh, rules):
    """One logical name -> mesh axis entry (str | tuple | None)."""
    if axis is None:
        return None
    entry = rules.get(axis) if isinstance(axis, str) else axis
    if entry is None:
        return None
    names = axis_names(mesh)
    if isinstance(entry, (tuple, list)):
        if mesh is not None:
            entry = tuple(a for a in entry if a in names)
        return tuple(entry) if entry else None
    if mesh is not None and entry not in names:
        return None
    return entry


def logical(*axes) -> PartitionSpec:
    """Resolve logical axis names to a spec under the active mesh/rules.
    ``None`` entries stay replicated; unknown names resolve to ``None``."""
    mesh, rules = _ACTIVE["mesh"], _ACTIVE["rules"]
    return P(*(_resolve(a, mesh, rules) for a in axes))


def _entry_size(mesh, entry) -> int:
    """Number of shards an entry (mesh axis | tuple | None) produces."""
    if entry is None:
        return 1
    n = 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        n *= axis_size(mesh, a)
    return n


def _drop_indivisible(spec: PartitionSpec,
                      shape: Sequence[int]) -> PartitionSpec:
    """Replace entries whose shard count does not divide the dim with
    ``None`` (replicated)."""
    mesh = _ACTIVE["mesh"]
    if mesh is None:
        return spec
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        if entry is not None and int(dim) % _entry_size(mesh, entry) != 0:
            entry = None
        out.append(entry)
    return P(*out)


def _dedupe_axes(spec: PartitionSpec) -> PartitionSpec:
    """Drop repeated mesh axes (first occurrence wins): a spec may not use
    one mesh axis on two dims."""
    seen: set = set()
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept = tuple(a for a in axes if a not in seen)
        seen.update(kept)
        if not kept:
            out.append(None)
        elif isinstance(entry, tuple):
            out.append(kept)
        else:
            out.append(kept[0])
    return P(*out)


def placements(mesh, spec: PartitionSpec, ndim: int) -> list:
    """DTensor placements of a rank-``ndim`` tensor under ``spec``: mesh dim
    ``a`` shards the tensor dim whose entry names it, else replicates.
    A tuple entry must list its axes in mesh order (outer first), the
    order in which DTensor splits one dim over several mesh dims."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    dim_of = {}
    for d, entry in enumerate(tuple(spec)[:ndim]):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec entry {entry!r} is not in mesh order "
                             f"{names}")
        for a in axes:
            dim_of[a] = d
    return [Shard(dim_of[a]) if a in dim_of else Replicate() for a in names]


def local_shape(shape: Sequence[int], mesh, spec: PartitionSpec) -> tuple:
    """The per-device shape of a ``shape`` tensor under ``spec`` (every
    entry divides its dim: specs come through ``_drop_indivisible``)."""
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        out.append(int(dim) // _entry_size(mesh, entry))
    return tuple(out)


def local_bytes(t: torch.Tensor, mesh, spec: PartitionSpec) -> int:
    n = 1
    for s in local_shape(t.shape, mesh, spec):
        n *= s
    return n * t.element_size()


def shard(x, *axes):
    """The reference's activation constraint: returns ``x`` as it is.

    The port places activations explicitly (``dist.group``): a meshed
    run holds this rank's rows of the batch and, under ``fsdp_cp``, its
    block of the sequence, and gathers the attention keys and values
    where the reference's constraint replicates them; a decode step
    holds its share of the attention heads (the reference's ``"kv"`` and
    ``"heads"`` constraints) and gathers the output's.  Nothing else has
    a layout to place until the tensor-parallel split of the kernels
    gives ``'model'`` one (``parallelism="tp"``); the model calls no
    ``shard``."""
    return x


# ---------------------------------------------------------------------------
# parameter sharding rules
# ---------------------------------------------------------------------------
# (regex, trailing-dims logical spec), matched with re.search against the
# state-dict name with '/' for '.', first hit wins; the spec is right-
# aligned against the leaf shape.  Covers every parameter of every
# registered arch (tests/test_torch_sharding.py enforces totality).

_PARAM_RULES = (
    # token embedding / output head: vocab-parallel
    (r"embed/tok$",                    ("vocab", None)),
    (r"lm_head/w$",                    (None, "vocab")),
    # modality frontends (d_model -> d_model projections): replicated
    (r"frontend/(patch|frame)_proj/w$", (None, None)),
    (r"frontend/(patch|frame)_proj/b$", (None,)),
    # attention (+ cross-attention: 'xattn/wq' also matches 'attn/wq')
    (r"attn/w[qkv]/w$",                (None, "heads")),
    (r"attn/w[qkv]/b$",                ("heads",)),
    (r"attn/wo/w$",                    ("heads", None)),
    (r"attn/wo/b$",                    (None,)),
    # dense MLP
    (r"mlp/w_(up|gate)/w$",            (None, "ffn")),
    (r"mlp/w_(up|gate)/b$",            ("ffn",)),
    (r"mlp/w_down/w$",                 ("ffn", None)),
    (r"mlp/w_down/b$",                 (None,)),
    # MoE: router replicated, expert stacks expert-parallel
    (r"moe/router/w$",                 (None, None)),
    (r"moe/w_(gate|up)$",              ("experts", None, None)),
    (r"moe/w_down$",                   ("experts", None, None)),
    # mamba: d_inner channel-parallel
    (r"mamba/in_proj/w$",              (None, "inner")),
    (r"mamba/conv_w$",                 (None, "inner")),
    (r"mamba/x_proj/w$",               ("inner", None)),
    (r"mamba/dt_proj$",                (None, "inner")),
    (r"mamba/dt_bias$",                ("inner",)),
    (r"mamba/a_log$",                  ("inner", None)),
    (r"mamba/d$",                      ("inner",)),
    (r"mamba/out_proj/w$",             ("inner", None)),
    # rwkv6: head-channel parallel on the d_model-sized attention dim
    (r"rwkv/mu$",                      (None, None)),
    (r"rwkv/w_[rkvg]/w$",              (None, "heads")),
    (r"rwkv/decay_w$",                 ("heads",)),
    (r"rwkv/decay_lora_a$",            (None, None)),
    (r"rwkv/decay_lora_b$",            (None, "heads")),
    (r"rwkv/bonus_u$",                 ("heads",)),
    (r"rwkv/w_o/w$",                   ("heads", None)),
    (r"rwkv/ln_x/(scale|bias)$",       ("heads",)),
    # norms (rmsnorm/layernorm, top-level and per-layer): replicated
    (r"(norm1|norm2|ln1|ln2|ln_x|final_norm|enc_norm|dec_norm)"
     r"/(scale|bias)$",                (None,)),
)

# MoE expert-FFN weights whose d_ff dim is additionally sharded over 'data'
# (weight-FSDP, arctic-480b); dim index of d_ff from the right.
_MOE_FFN_DIM = {r"moe/w_(gate|up)$": -1, r"moe/w_down$": -2}


def param_spec(name: str, shape: Sequence[int],
               moe_ffn_shard_data: bool = False) -> PartitionSpec:
    """The spec of one parameter (state-dict ``name``, ``shape``) under the
    active mesh and rules."""
    mesh, rules = _ACTIVE["mesh"], _ACTIVE["rules"]
    path = name.replace(".", "/")
    template = None
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path):
            template = list(spec)
            break
    if template is None:
        raise KeyError(f"no sharding rule matches parameter {name!r}")
    if moe_ffn_shard_data:
        for pat, dim in _MOE_FFN_DIM.items():
            if re.search(pat, path) and template[dim] is None:
                template[dim] = "data"
    ndim = len(shape)
    entries = [None] * max(ndim - len(template), 0) + template
    resolved = P(*(_resolve(e, mesh, rules) for e in entries[:ndim]))
    return _drop_indivisible(resolved, shape)


def param_pspecs(state: dict, moe_ffn_shard_data: bool = False) -> dict:
    """{state-dict name: spec} for a state dict (or a model's named
    parameters).  Every name must match a ``_PARAM_RULES`` entry;
    ``moe_ffn_shard_data`` also spreads the MoE expert d_ff dim over
    'data' (arctic-480b weight-FSDP)."""
    return {name: param_spec(name, t.shape, moe_ffn_shard_data)
            for name, t in state.items()}


# ---------------------------------------------------------------------------
# ZeRO-1 optimizer-state upgrade
# ---------------------------------------------------------------------------

def _spec_mesh_axes(spec: PartitionSpec):
    for entry in spec:
        if entry is None:
            continue
        yield from (entry if isinstance(entry, tuple) else (entry,))


def zero1_upgrade(spec: PartitionSpec, shape: Sequence[int],
                  mesh) -> PartitionSpec:
    """Shard the first divisible, unsharded dim over 'data' (optimizer-state
    ZeRO-1).  Never duplicates a mesh axis: if 'data' already appears in
    the spec it is returned unchanged."""
    if "data" not in axis_names(mesh):
        return spec
    if "data" in set(_spec_mesh_axes(spec)):
        return spec
    n = axis_size(mesh, "data")
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, dim in enumerate(shape):
        if parts[i] is None and int(dim) % n == 0:
            parts[i] = "data"
            break
    return P(*parts)


# ---------------------------------------------------------------------------
# placing parameters and reading them for compute
# ---------------------------------------------------------------------------

def place(t: torch.Tensor, mesh, spec: PartitionSpec):
    """``t`` (the whole value, the same on every rank) as a DTensor placed
    by ``spec``: each rank keeps its own block, nothing is sent."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements(mesh, spec, t.ndim),
                             src_data_rank=None)


def zeros_placed(shape, dtype, device, mesh, spec: PartitionSpec):
    """A zeroed DTensor of global ``shape`` placed by ``spec``, allocating
    only this rank's block (on ``device``, ``meta`` included)."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    loc = torch.zeros(local_shape(shape, mesh, spec), dtype=dtype,
                      device=device)
    return DTensor.from_local(
        loc, mesh, placements(mesh, spec, len(shape)), run_check=False,
        shape=shape, stride=torch.empty(shape, device="meta").stride())


def whole(t):
    """The whole value of a DTensor (a plain tensor as it is)."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def local(t):
    """A DTensor's block on this rank (a plain tensor as it is)."""
    return t.to_local() if hasattr(t, "to_local") else t


def assign(dst, src) -> None:
    """``dst <- src`` in place (dicts of tensors leaf by leaf); into a
    DTensor ``dst``'s own block, from a DTensor of any placement or from
    the whole value."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(dst, dict):
        for k in dst:
            assign(dst[k], src[k])
        return
    if isinstance(dst, DTensor):
        src = src.redistribute(dst.device_mesh, dst.placements) \
            if isinstance(src, DTensor) else distribute_tensor(
                src, dst.device_mesh, dst.placements, src_data_rank=None)
        dst.to_local().copy_(src.to_local())
    else:
        dst.copy_(src)


def full(t):
    """A tensor as compute reads it: a DTensor gathered to its whole value,
    anything else as it is.  While the rows are split over mesh axes
    (``dist.group.split_rows``: the batch over the data axes, the
    sequence over ``'model'``) each rank's gradient is a partial sum over
    those axes, and the backward reduces it there."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    split = _ACTIVE["split"]
    grad = [Partial() if n in split else Replicate()
            for n in axis_names(mesh)]
    if all(p.is_replicate() or mesh.size(i) == 1
           for i, p in enumerate(t.placements)):
        return t.to_local(grad_placements=grad)      # already whole here
    return t.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=grad)


@contextlib.contextmanager
def gathered(module, skip: frozenset = frozenset()):
    """Swap every DTensor parameter under ``module`` (modules in ``skip``
    excepted) for its gathered value (:func:`full`) in the dynamic
    extent; a module with none is left as it is."""
    from torch.distributed.tensor import DTensor
    swapped = []
    for mod in module.modules():
        if id(mod) in skip:
            continue
        for name, p in list(mod._parameters.items()):
            if isinstance(p, DTensor):
                mod._parameters[name] = full(p)
                swapped.append((mod, name, p))
    try:
        yield module
    finally:
        for mod, name, p in swapped:
            mod._parameters[name] = p


def gather_hooks(model) -> list:
    """Gather a model's DTensor parameters for the forwards that read
    them: each layer of a ModuleList for its forward (and again for a
    rematerialised recompute), the root's modules outside the lists for
    the whole call, and any module that owns parameters when it is called
    on its own (a cross-attention's keys from the encoder output).
    Returns the hook handles."""
    lists = [m for m in model.modules() if isinstance(m, torch.nn.ModuleList)]
    in_list = frozenset(id(sub) for lst in lists for sub in lst.modules())
    units = {id(model): (model, in_list)}
    for lst in lists:
        for sub in lst:
            units.setdefault(id(sub), (sub, frozenset()))
    for mod in model.modules():
        if any(p is not None for p in mod._parameters.values()):
            units.setdefault(id(mod), (mod, frozenset()))
    handles = []
    for unit, skip in units.values():
        state: list = []

        def pre(mod, args, skip=skip, state=state):
            ctx = gathered(mod, skip)
            ctx.__enter__()
            state.append(ctx)

        def post(mod, args, out, state=state):
            state.pop().__exit__(None, None, None)

        handles.append(unit.register_forward_pre_hook(pre))
        handles.append(unit.register_forward_hook(post, always_call=True))
    return handles
