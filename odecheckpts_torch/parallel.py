"""Batched and multi-device IVP solving (PyTorch counterpart of
``odecheckpts_tpu.parallel``).

PyTorch runs one process per device: a rank holds one device, and the mesh
is a 1-D ``torch.distributed.device_mesh.DeviceMesh`` over the ranks whose
axis is named as the reference's ``axis`` argument.  The reference's single
process with a mesh over every local device is, here, a world of one rank
(``init_distributed()`` without arguments).

* ``build_batched_solve`` -- an ensemble of IVPs x tolerances through
  ``facade.solve``, which takes leading batch axes and per-lane tolerances;
  returns the reference's batch-leading layout.
* ``shard_engine_solve`` / ``shard_fused_solve`` / ``shard_batched_solve``
  -- a batched solve laid out over the mesh.  Each takes the GLOBAL batch on
  every rank (the reference takes global arrays), pads it to a multiple of
  the mesh size with copies of the loosest-tolerance lane, solves the rank's
  contiguous block, gathers every output leaf along its leading axis and
  returns the global result on every rank.
* ``build_dp_train_step`` -- data-parallel parameter estimation: each rank
  sums the negative log-marginal likelihood over its block, loss and
  gradients are combined with one ``all_reduce(SUM)``, and every rank takes
  the same ``torch.optim`` step on its replica of the parameters.

Collectives run on the mesh axis' process group.  Gloo takes CPU tensors
here: a CUDA tensor on a gloo group (two ranks sharing one card, which NCCL
refuses) is staged through the host explicitly.  ``COUNTS`` holds the
collectives run, the bytes they gathered and the bytes staged; reset it
with ``reset_counts()``.
"""

from __future__ import annotations

import os
import subprocess
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from . import facade, harness, stats
from .train import _flatten

COUNTS = {"gathers": 0, "bytes_gathered": 0, "all_reduces": 0, "broadcasts": 0,
          "bytes_host_staged": 0}


# torch 2.13 names it all_gather_single; earlier releases all_gather_into_tensor
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def reset_counts():
    for key in COUNTS:
        COUNTS[key] = 0


def init_distributed(*, device=None, **kwargs):
    """Initialize ``torch.distributed`` and return a 1-D mesh named
    ``("batch",)`` over every rank (``odecheckpts_tpu/parallel.py:32-53``).

    Opt-in, as in the reference: with ``kwargs`` or ``ODECKPT_DISTRIBUTED=1``
    this calls ``init_process_group(**kwargs)`` (``env://`` by default, so
    ``torchrun --nproc-per-node N`` works); otherwise it makes a world of one
    on this process's device over an in-process ``HashStore``, with no
    environment variables needed.  An initialized default group is reused.

    ``device``: "cuda" (default; the rank's card is ``device``'s index, else
    ``LOCAL_RANK``, else the current device) or "cpu".  The backend is NCCL
    on "cuda" and gloo on "cpu" unless ``kwargs`` name another; NCCL takes
    one rank a card, so ranks that share a card pass ``backend="gloo"``."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda') needs a CUDA device; pass "
                               "device='cpu' for gloo on the host")
        index = device.index
        if index is None:
            index = int(os.environ.get("LOCAL_RANK", torch.cuda.current_device()))
        torch.cuda.set_device(index)
        torch.cuda.init()  # the mesh keeps the card set here
    elif device.type != "cpu":
        raise ValueError(f"init_distributed runs on 'cuda' or 'cpu', got {device}")
    if not dist.is_initialized():
        backend = kwargs.pop("backend", "nccl" if device.type == "cuda" else "gloo")
        if kwargs or os.environ.get("ODECKPT_DISTRIBUTED") == "1":
            dist.init_process_group(backend, **kwargs)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(device.type, (dist.get_world_size(),), mesh_dim_names=("batch",))


def check_mesh(mesh, axis, what="mesh"):
    """Raise ``ValueError`` unless ``mesh`` is a 1-D ``DeviceMesh`` whose
    axis is named ``axis``."""
    if not (isinstance(mesh, DeviceMesh) and mesh.ndim == 1
            and axis in (mesh.mesh_dim_names or ())):
        raise ValueError(f"{what} takes a 1-D torch.distributed DeviceMesh with the axis "
                         f"{axis!r} (see init_distributed), got {mesh!r}")


class AxisGroup:
    """The ranks of one mesh axis and the collectives this package runs over
    them: ``gather`` (along the leading axis), ``all_sum``, ``max`` (NaN
    wins, on every backend), ``broadcast``, ``left`` (the left neighbour's
    tensor, a halo of one) and ``carry_prefix`` (a distributed inclusive
    scan from per-rank local prefixes)."""

    def __init__(self, mesh, axis):
        check_mesh(mesh, axis)
        self.group = mesh.get_group(axis)
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.host_staged = dist.get_backend(self.group) == "gloo"

    def _wire(self, x):
        """``x`` as the backend takes it: contiguous, bool as uint8, and on
        the host for gloo."""
        x = x.contiguous()
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        if self.host_staged and x.device.type != "cpu":
            COUNTS["bytes_host_staged"] += x.numel() * x.element_size()
            x = x.cpu()
        return x

    def gather(self, x):
        """Every rank's ``x`` concatenated along the leading axis, in rank
        order (0-d tensors are stacked)."""
        like = x
        src = self._wire(x if x.dim() else x[None])
        out = src.new_empty((self.size * src.shape[0],) + tuple(src.shape[1:]))
        _all_gather_single(out, src, group=self.group)
        COUNTS["gathers"] += 1
        COUNTS["bytes_gathered"] += out.numel() * out.element_size()
        return out.to(device=like.device, dtype=like.dtype)

    def _all_reduce(self, x, op):
        src = self._wire(x)
        dist.all_reduce(src, op=op, group=self.group)
        COUNTS["all_reduces"] += 1
        return src.to(device=x.device, dtype=x.dtype)

    def all_sum(self, x):
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def max(self, x):
        """The largest of every rank's 0-d ``x``; NaN where any rank holds
        NaN (as ``torch.max`` over the concatenation), on every backend."""
        nan = torch.isnan(x)
        packed = torch.stack([torch.where(nan, torch.full_like(x, -torch.inf), x),
                              nan.to(x.dtype)])
        packed = self._all_reduce(packed, dist.ReduceOp.MAX)
        return torch.where(packed[1] > 0, torch.full_like(x, torch.nan), packed[0])

    def broadcast(self, x):
        """Rank 0's ``x`` on every rank (a new tensor)."""
        buf = self._wire(x.clone())
        dist.broadcast(buf, src=dist.get_global_rank(self.group, 0), group=self.group)
        COUNTS["broadcasts"] += 1
        return buf.to(device=x.device, dtype=x.dtype)

    def left(self, last, first):
        """The left neighbour's ``last``, and ``first`` on rank 0."""
        every = self.gather(last[None])
        return first if self.rank == 0 else every[self.rank - 1]

    def carry_prefix(self, prefix, combine, dim):
        """The global inclusive prefix from each rank's local one: gather the
        ranks' last prefix elements, fold those to this rank's left (at most
        ``size - 2`` combines) and combine that carry, broadcast along
        ``dim``, into every local element (one more combine)."""
        last = tuple(torch.movedim(x.narrow(dim, x.shape[dim] - 1, 1), dim, 0) for x in prefix)
        totals = tuple(self.gather(x) for x in last)  # (size, ...) each
        if self.rank == 0:
            return prefix

        def total(r):
            return tuple(torch.movedim(t[r:r + 1], 0, dim).contiguous() for t in totals)

        carry = total(0)
        for r in range(1, self.rank):
            carry = combine(carry, total(r))
        carry = tuple(c.expand_as(x).contiguous() for c, x in zip(carry, prefix))
        return combine(carry, prefix)


def _tree_map(fn, tree):
    """``fn`` on every tensor of nested tuples / lists / named tuples / dicts;
    other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    return tree


def replicate(tree, mesh, axis="batch"):
    """Every tensor of ``tree`` as rank 0 holds it, on every rank of the
    mesh axis (``odecheckpts_tpu/parallel.py:180-183``)."""
    group = AxisGroup(mesh, axis)
    return _tree_map(group.broadcast, tree)


def shard_along(tree, mesh, axis="batch"):
    """This rank's contiguous block of the leading axis of every tensor of
    ``tree``, as ``PartitionSpec(axis)`` lays it out
    (``odecheckpts_tpu/parallel.py:186-189``); a leading axis that the
    mesh axis does not divide raises ``ValueError``."""
    group = AxisGroup(mesh, axis)

    def block(x):
        n = x.shape[0]
        if n % group.size:
            raise ValueError(f"a leading axis of {n} does not divide into the "
                             f"{group.size} ranks of mesh axis {axis!r}")
        size = n // group.size
        return x[group.rank * size:(group.rank + 1) * size]

    return _tree_map(block, tree)


def shard_engine_solve(solve_local, mesh, axis="batch"):
    """Lay any batched engine ``solve_local(u0s, tols) -> outputs`` over the
    mesh axis (``odecheckpts_tpu/parallel.py:116-157``).

    ``sharded(u0s, tols)`` takes the global batch on every rank: ``u0s`` a
    (B, d) tensor or a tuple of them (``ode_order=2``), ``tols`` (B,).  A
    batch that the axis does not divide is padded with copies of the
    loosest-tolerance lane (``argmax(tols)``: the engines run each tile to
    its slowest lane), leaf by leaf.  The rank solves its contiguous block,
    every output tensor (batch-leading, as every ``batched*`` engine returns
    them) is gathered along its leading axis and sliced back to B: every
    rank returns the global result."""
    check_mesh(mesh, axis)

    def sharded(u0s, tols):
        group = AxisGroup(mesh, axis)
        is_tuple = isinstance(u0s, tuple)
        u_tuple = u0s if is_tuple else (u0s,)
        b = u_tuple[0].shape[0]
        tols = torch.as_tensor(tols, device=u_tuple[0].device)
        pad = (-b) % group.size
        if pad:
            loosest = int(torch.argmax(tols))

            def rep(x):
                return torch.cat([x, x[loosest:loosest + 1].expand((pad,) + tuple(x.shape[1:]))])

            u_tuple = tuple(rep(u) for u in u_tuple)
            tols = rep(tols)
        size = (b + pad) // group.size
        lo = group.rank * size
        local = tuple(u[lo:lo + size] for u in u_tuple)
        out = solve_local(local if is_tuple else local[0], tols[lo:lo + size])
        return _tree_map(lambda x: group.gather(x)[:b], out)

    return sharded


def shard_fused_solve(vf, params, *, save_at, dt0, mesh, axis="batch", **solve_kwargs):
    """The fused batched engine (``batched.solve_save_at_batched``) laid out
    over the mesh axis (``odecheckpts_tpu/parallel.py:160-177``): each rank
    runs the engine's kernels (K1 with ``engine="cuda-loop"``, K3 with
    ``"cuda"``) on its block.  ``solve_kwargs`` go to the engine; the memory
    admission check applies per rank.  Returns ``sharded(u0s, tols) ->
    (u_smoothed, u_filtered, num_steps)``, padded as ``shard_engine_solve``."""
    from . import batched

    def local(u, t):
        return batched.solve_save_at_batched(vf, u, params, save_at=save_at, dt0=dt0, tols=t,
                                             **solve_kwargs)

    return shard_engine_solve(local, mesh, axis)


def build_batched_solve(method, vf, u0_like, save_at, *, dt0, ode_order=1,
                        calibrate="dynamic", implementation="isotropic", atol_factor=1e-3):
    """``solve_batch(u0_tuple, params, tols) -> (u, num_steps)``
    (``odecheckpts_tpu/parallel.py:56-96``): ``u0_tuple`` holds tensors with
    a leading batch axis, ``tols`` (B,) relative tolerances (atol =
    ``atol_factor`` rtol).  One ``facade.solve`` over the batch, each lane
    with its own steps; returns the reference's layout, ``u`` (B, T, d) and
    each lane's accepted steps at the last checkpoint (B,)."""

    def solve_batch(u0s, params, tols):
        like = u0s[0]
        tols = torch.as_tensor(tols, dtype=like.dtype, device=like.device)
        fun = facade.solve(method, vf, u0_like, save_at, dt0=dt0, atol=atol_factor * tols,
                           rtol=tols, ode_order=ode_order, calibrate=calibrate,
                           implementation=implementation)
        u, aux = fun(tuple(u0s), params)
        return torch.movedim(u, 0, 1), aux["solution"].num_steps[-1]

    return solve_batch


def shard_batched_solve(solve_batch, mesh, axis="batch"):
    """``sharded(u0s, params, tols)``: ``solve_batch`` over the mesh axis
    (``odecheckpts_tpu/parallel.py:99-113``); the batch is split, ``params``
    replicated, the outputs gathered as in ``shard_engine_solve``."""

    def sharded(u0s, params, tols):
        return shard_engine_solve(lambda u, t: solve_batch(u, params, t), mesh, axis)(u0s, tols)

    return sharded


def build_dp_train_step(method, vf, u0_like, save_at, *, dt0, atol, rtol, optimizer, mesh,
                        axis="dp", obs_std=1e-2):
    """Data-parallel training step over an IVP ensemble
    (``odecheckpts_tpu/parallel.py:192-248``).

    Returns ``step(params, opt_state, u0_batch, y_batch) -> (params,
    opt_state, loss)``.  ``u0_batch`` (B, d) and ``y_batch`` (B, T, d) are
    the global batch on every rank; each rank takes its block
    (``shard_along``) and sums -``log_marginal_likelihood`` (noise
    ``obs_std``) over it through ``facade.solve(..., calibrate="none")``.
    Loss and gradients are combined with one ``all_reduce(SUM)``: the loss
    is the batch's SUM, as the reference's ``psum`` makes it.  ``params`` is
    a tensor or a nesting of them (``train._flatten``); ``opt_state`` is
    None on the first call, which builds ``optimizer(leaves)`` (a
    ``torch.optim`` factory, as ``train.fit`` takes) on leaf copies of
    ``params``' tensors, and the returned optimizer afterwards.  Every rank
    takes the same optimizer step; the returned ``params`` are detached
    copies of the updated leaves, in ``params``' nesting.  Wrap the call in
    ``control_flow.overwrite_with_bounded`` for the backward pass through
    the adaptive loop, as the reference's callers do."""
    check_mesh(mesh, axis)
    solve = facade.solve(method, vf, u0_like, save_at, dt0=dt0, atol=atol, rtol=rtol,
                         calibrate="none")

    def local_loss(theta, u0_local, y_local):
        _u, aux = solve((u0_local,), theta)
        std = obs_std * torch.ones(len(save_at), dtype=y_local.dtype, device=y_local.device)
        lml = stats.log_marginal_likelihood(torch.movedim(y_local, 0, 1), standard_deviation=std,
                                            posterior=aux["solution"].posterior)
        return -torch.sum(lml)

    def step(params, opt_state, u0_batch, y_batch):
        group = AxisGroup(mesh, axis)
        u0_local, y_local = shard_along((u0_batch, y_batch), mesh, axis)
        given, unflatten = _flatten(params)
        if opt_state is None:
            leaves = [p.detach().clone().requires_grad_(True) for p in given]
            opt_state = optimizer(leaves)
        else:
            leaves = [p for g in opt_state.param_groups for p in g["params"]]
            with torch.no_grad():
                for p, v in zip(leaves, given, strict=True):
                    if p is not v:
                        p.copy_(v)
        loss = local_loss(unflatten(leaves), u0_local, y_local)
        grads = torch.autograd.grad(loss, leaves)
        packed = torch.cat([loss.detach().reshape(1)]
                           + [g.reshape(-1).to(loss.dtype) for g in grads])
        packed = group.all_sum(packed)
        at = 1
        for p, g in zip(leaves, grads):
            p.grad = packed[at:at + g.numel()].reshape(g.shape).to(g.dtype)
            at += g.numel()
        opt_state.step()
        return unflatten([p.detach().clone() for p in leaves]), opt_state, packed[0]

    return step


def start_ranks(argv, world, env=None):
    """Start ``world`` processes, rank ``r`` running the command ``argv(r)``,
    their standard output and error captured together; ``wait_ranks``
    collects them."""
    return [subprocess.Popen(argv(r), env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(world)]


def wait_ranks(procs, timeout):
    """Wait for the processes of ``start_ranks`` and return their outputs;
    kill any still running after ``timeout`` seconds, and raise
    ``RuntimeError`` with the output's end of every rank that failed."""
    logs = []
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, log[-4000:]) for r, (p, log) in enumerate(zip(procs, logs))
              if p.returncode != 0]
    if failed:
        raise RuntimeError(f"ranks failed (rank, exit code, output): {failed}")
    return logs


def workprec_batched(solve_batch, u0s, params, tols):
    """Run a batched sweep once after a warm-up and report throughput
    (``odecheckpts_tpu/parallel.py:251-270``)."""
    u, steps = solve_batch(u0s, params, tols)
    harness.device_sync(u)
    t0 = time.perf_counter()
    u, steps = solve_batch(u0s, params, tols)
    harness.device_sync(u)
    elapsed = time.perf_counter() - t0
    batch = torch.as_tensor(tols).shape[0]
    return {"batch": batch, "wall_s": elapsed, "solves_per_s": batch / elapsed,
            "total_steps": int(torch.sum(steps)), "u": u}
