"""A step's cost counted on meta tensors: the dry run's counter.

:class:`StepCount` is a ``TorchDispatchMode``: every ATen operation that
runs under it is counted after autograd, so a train step's forward, its
recomputation under remat, its backward and the optimizer all count, each
loop iteration on its own (a Python loop runs every iteration, where
XLA's ``cost_analysis`` counts a loop body once).  It records

- the products' FLOPs: ``mm``, ``addmm``, ``bmm`` and ``baddbmm`` at 2
  FLOPs a multiply-add (``products``, and by operation in
  ``products_by_op``);
- the kernels' calls by source, their launches, FLOPs and bytes, from
  the meta route (:mod:`repro_torch.kernels.work`), which the wrappers
  take on meta tensors;
- the bytes each other operation reads and writes: every tensor argument
  read once and every tensor result written once; views and
  allocations move nothing.  This is the port's eager count, operation
  by operation, not a fused compiler's;
- the live bytes: every storage on the meta device from the first
  operation that sees it until it is freed, and their peak (``peak``).
  Tensors made before the count starts are added by :meth:`track`.
"""
from __future__ import annotations

import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import work

aten = torch.ops.aten
#: the operations counted as products
PRODUCTS = (aten.mm, aten.addmm, aten.bmm, aten.baddbmm)
#: allocations: they move no bytes (a fill is counted)
_ALLOCS = (aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
           aten.new_empty_strided)


def product_flops(func, args) -> int:
    """2 x the multiply-adds of one product operation, else 0."""
    p = func._overloadpacket
    if p is aten.mm:
        a, b = args[0], args[1]
    elif p is aten.addmm:
        a, b = args[1], args[2]
    elif p is aten.bmm:
        a, b = args[0], args[1]
    elif p is aten.baddbmm:
        a, b = args[1], args[2]
    else:
        return 0
    return 2 * a.numel() * b.shape[-1]


#: (operation, its arguments' metadata) -> its results' metadata: an
#: operation that returns new tensors gives the same shapes for the same
#: arguments, so a repeat (a layer's or a time step's) skips the meta
#: implementation, which runs in Python and costs far more than the count
_RESULTS: Dict[tuple, tuple] = {}


def _fresh(func) -> bool:
    """Whether ``func`` only returns new tensors: no result aliases an
    argument and nothing is written in place."""
    schema = func._schema
    return not schema.is_mutable and all(
        r.alias_info is None for r in schema.returns)


def _key(x, tensors: list):
    """A hashable stand-in for an argument tree (tensors by shape, stride
    and dtype), its tensors appended to ``tensors``."""
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        return (tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return (type(x),) + tuple(_key(y, tensors) for y in x)
    if isinstance(x, dict):
        return tuple((k, _key(v, tensors)) for k, v in x.items())
    return x


def _template(out):
    """The results' metadata, or None where a result is not a tensor, a
    list or tuple of them, or None."""
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        parts = [_template(y) for y in out]
        if any(p is None and y is not None for p, y in zip(parts, out)):
            return None
        return (type(out), parts)
    return None


def _build(t):
    if t is None:
        return None
    if isinstance(t[0], type):
        return t[0](_build(y) for y in t[1])
    return torch.empty_strided(t[0], t[1], dtype=t[2], device="meta")


def _run(func, args, kwargs, tensors: list):
    """``func(*args, **kwargs)`` on meta tensors, or its results made
    from the metadata of an earlier call with arguments of the same
    shapes, strides, dtypes and values; ``tensors`` receives the
    arguments' tensors."""
    key = (func, _key(args, tensors), _key(kwargs, tensors))
    if not _fresh(func) or any(t.device.type != "meta" for t in tensors):
        return func(*args, **kwargs)
    try:
        hit = _RESULTS.get(key)
    except TypeError:                   # an unhashable argument
        return func(*args, **kwargs)
    if hit is not None:
        return _build(hit)
    out = func(*args, **kwargs)
    template = _template(out)
    if template is not None:
        _RESULTS[key] = template
    return out


def _outputs(out, found: list) -> list:
    if isinstance(out, torch.Tensor):
        found.append(out)
    elif isinstance(out, (list, tuple)):
        for y in out:
            _outputs(y, found)
    return found


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCount(TorchDispatchMode):
    """Counts what runs under it (``with StepCount() as c: ...``)."""

    def __init__(self):
        super().__init__()
        self.products = 0
        self.products_by_op: Dict[str, int] = {}
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.kernels = work.KernelTally()
        self._seen = WeakIdKeyDictionary()

    # -- live bytes --------------------------------------------------------

    def _free(self, n: int) -> None:
        self.live -= n

    def _see(self, t: torch.Tensor) -> None:
        if t.device.type != "meta":
            return
        st = t.untyped_storage()
        if st in self._seen:
            return
        self._seen[st] = True
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def track(self, *trees) -> int:
        """Adds the storages of every tensor in ``trees`` (nested dicts,
        lists and tuples) to the live bytes; returns the bytes added."""
        before = self.live
        for tree in trees:
            for x in tree_flatten(tree)[0]:
                if isinstance(x, torch.Tensor):
                    self._see(x)
        return self.live - before

    # -- the mode ----------------------------------------------------------

    def __enter__(self):
        self.kernels.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        self.kernels.__exit__(*exc)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins: list = []
        out = _run(func, args, kwargs, ins)
        outs = _outputs(out, [])
        for t in ins:
            self._see(t)
        for t in outs:
            self._see(t)
        if func._overloadpacket in PRODUCTS:
            f = product_flops(func, args)
            self.products += f
            name = func._overloadpacket.__name__
            self.products_by_op[name] = self.products_by_op.get(name, 0) + f
        if not (func.is_view or func._overloadpacket in _ALLOCS):
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        return out

    # -- totals ------------------------------------------------------------

    @property
    def kernel_flops(self) -> int:
        return sum(r["flops"] for r in self.kernels.by_source.values())

    @property
    def kernel_bytes(self) -> int:
        return sum(r["bytes"] for r in self.kernels.by_source.values())

    @property
    def flops(self) -> int:
        """Products plus the kernels' work."""
        return self.products + self.kernel_flops

    @property
    def total_bytes(self) -> int:
        """The operations' bytes plus the kernels'."""
        return self.bytes + self.kernel_bytes
