"""A traced step's counts and roofline terms (port of
``repro.launch.hlo_analysis``).

The reference reads an XLA executable: ``cost_analysis()`` for FLOPs and
bytes, and the optimized HLO text for the collectives' operand bytes.
The port has no HLO.  :func:`count_step` runs a step once under two
dispatch modes and counts, op by op, what the eager step does:

* **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode``'s formulas,
  which count the products only (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, attention and convolutions, their backward passes
  included), where XLA counts elementwise work too;
* **bytes accessed**: each ``aten`` op's tensor inputs plus its tensor
  outputs (elements x element size).  Views, and ``empty``-like ops that
  touch no element, count nothing; an in-place op counts its operand
  once as read and once as written.  This is each eager op's own
  traffic, not that of a fused program;
* **ops**: the ``aten`` ops it ran;
* **peak bytes**: the live storage bytes at their highest, the step's
  arguments included -- each storage counted once, when an op first
  returns it (views and in-place ops add nothing) and freed when its
  last reference goes, so autograd's saved tensors and the recomputed
  activations of remat count as they live on the card;
* **collectives**: those ``sharding.api`` counts, ``{(kind, axis,
  operand bytes): count}``.

The same function runs on real tensors: on ``meta`` tensors (the dry
run, ``launch.dryrun``) it counts a step that no card holds.

**Rates.**  The roofline terms price the counts at an NVIDIA H100 SXM5
80GB's data-sheet rates at its 700 W power limit: :data:`PEAK_FLOPS`
989e12 (bf16, dense tensor cores), :data:`HBM_BW` 3.35e12 B/s, and one
network rate, :data:`NET_BW` 50e9 B/s a card (InfiniBand NDR, 400 Gb/s),
where the reference has its ICI rate: a 16-way axis leaves an 8-card
NVLink board, so both axes of the ``(16, 16)`` mesh cross the network.
These are not the reference's rates (a TPU v5e: 197e12 FLOP/s, 819e9
B/s, 50e9 B/s a link).
"""

from __future__ import annotations

import collections
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.sharding import api

PEAK_FLOPS = 989e12        # bf16 / card, dense tensor cores
HBM_BW = 3.35e12           # bytes/s / card
NET_BW = 50e9              # bytes/s / card over the network (400 Gb/s)

# ops that allocate without touching an element
_NO_ACCESS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided"})


def collective_bytes(records: dict) -> dict[str, int]:
    """Bytes moved per collective kind: the operand bytes of every
    collective in ``records`` (``sharding.api.collective_bytes()``'s
    ``{(kind, axis, operand bytes): count}``)."""
    out: dict[str, int] = collections.defaultdict(int)
    for (kind, _, nbytes), n in records.items():
        out[kind] += nbytes * n
    return dict(out)


@dataclasses.dataclass
class RooflineTerms:
    """Per-step roofline terms in seconds.

    ``hlo_flops / hlo_bytes / coll_bytes`` are PER-RANK quantities (the
    traced step is one rank's); ``model_flops`` is GLOBAL (6 N D for a
    train step, 2 N D for a forward).  The reference's names and
    formulas; ``t_collective`` is priced at :data:`NET_BW`."""

    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    n_chips: int
    model_flops: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NET_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the step's roofline-limited time:
        the model FLOPs' time over max(term)."""
        denom = max(self.t_compute, self.t_memory, self.t_collective)
        if denom <= 0:
            return 0.0
        return (self.model_flops / (self.n_chips * PEAK_FLOPS)) / denom

    @property
    def useful_flops_ratio(self) -> float:
        total_hlo = self.hlo_flops * self.n_chips
        return self.model_flops / total_hlo if total_hlo else 0.0

    def as_dict(self) -> dict:
        return {
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "n_chips": self.n_chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "roofline_fraction": self.roofline_fraction,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


@dataclasses.dataclass
class StepCount:
    """What :func:`count_step` counted over one call (module docstring):
    ``argument_bytes`` are the distinct storages of the call's arguments,
    ``peak_bytes`` the live storage bytes at their highest (arguments
    included), ``output_bytes`` the distinct storages of what it
    returned, ``aliased_bytes`` those of them that are arguments'
    storages (written in place)."""

    flops: int
    bytes: int
    ops: int
    peak_bytes: int
    argument_bytes: int
    output_bytes: int
    aliased_bytes: int
    collectives: dict


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storages(tree) -> dict:
    """{storage key: (storage, bytes)} of the tensors in ``tree``."""
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = (st, st.nbytes())
    return out


class _Counting(TorchDispatchMode):
    """Bytes, ops and the live storage bytes of every ``aten`` op."""

    def __init__(self, live: dict):
        super().__init__()
        self.bytes = self.ops = 0
        self.sizes = {}
        self.live = self.peak = 0
        for key, (st, n) in live.items():
            self._hold(key, st, n)

    def _hold(self, key, st, n: int) -> None:
        self.sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key).atexit = False

    def _free(self, key) -> None:
        self.live -= self.sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten":
            return out     # a collective's own op (c10d): counted apart
        self.ops += 1
        if not func.is_view and func.overloadpacket.__name__ not in _NO_ACCESS:
            self.bytes += sum(_nbytes(t) for t in tree_leaves((args, kwargs))
                              if isinstance(t, torch.Tensor))
            self.bytes += sum(_nbytes(t) for t in tree_leaves(out)
                              if isinstance(t, torch.Tensor))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st._cdata not in self.sizes:
                    self._hold(st._cdata, st, st.nbytes())
        return out


def count_step(fn, *args) -> StepCount:
    """Run ``fn(*args)`` once and count it (module docstring).  The
    arguments' storages are live from the start; the collectives are
    those the call issued through ``sharding.api``."""
    from torch.utils.flop_counter import FlopCounterMode

    arg_st = _storages(args)
    before = collections.Counter(api.collective_bytes())
    flops = FlopCounterMode(display=False)
    counting = _Counting(arg_st)
    with flops, counting:
        out = fn(*args)
    after = collections.Counter(api.collective_bytes())
    after.subtract(before)
    out_st = _storages(out)
    return StepCount(
        flops=flops.get_total_flops(), bytes=counting.bytes,
        ops=counting.ops, peak_bytes=counting.peak,
        argument_bytes=sum(n for _, n in arg_st.values()),
        output_bytes=sum(n for _, n in out_st.values()),
        aliased_bytes=sum(n for k, (_, n) in out_st.items() if k in arg_st),
        collectives={k: n for k, n in after.items() if n})


__all__ = ["collective_bytes", "count_step", "StepCount", "RooflineTerms",
           "PEAK_FLOPS", "HBM_BW", "NET_BW"]
