"""A ``torch.distributed`` world of a few processes for the tests (and for
``mesh_cards.py`` on several cards), and the rank bodies the
sharded-step tests run in it.

:class:`World` spawns ``world`` processes
(``torch.multiprocessing``, ``"spawn"``), each joining a ``gloo`` world
on the CPU, or an NCCL world on the cards, through a ``file://``
rendezvous (no port, so parallel test workers do not collide), runs one
body, and returns rank 0's result; it joins with a hard timeout and
raises rather than hang.  The bodies import ``torch`` and
``repro_torch`` only: the tests carry the reference's weights in as
numpy arrays and compare the numpy arrays that come back.

:func:`sharded_cases` is the body of ``tests/test_torch_distributed.py``:
on each mesh it asks for, it places a reduced model's parameters, train
state (with and without ZeRO-1), batch and cache, runs the sharded train
step under the asked variants, prefill and decode, and the collective
count of a baseline and a ZeRO-1 step.
"""
from __future__ import annotations

import dataclasses
import functools
import pickle
import queue
import time
import traceback

import numpy as np
import torch

from repro_torch.tree import tree_leaves_with_path, tree_map


def _entry(rank: int, world: int, init_file: str, backend: str, job: str,
           out):
    from repro_torch.launch.mesh import init_world
    if backend == "gloo":
        torch.set_num_threads(1)
    try:
        with open(job, "rb") as f:
            body, args = pickle.load(f)
        init_world(backend, init_method=f"file://{init_file}", rank=rank,
                   world_size=world)
        result = body(*args)
        if rank == 0:
            out.put(("ok", result))
    except BaseException:                                   # noqa: BLE001
        out.put(("error", f"rank {rank}:\n{traceback.format_exc()}"))
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


class World:
    """``body(*args)`` started on every rank of a ``world``-process world
    — ``gloo`` on the CPU, or ``nccl`` with rank r on ``cuda:r`` —;
    :meth:`result` waits for rank 0's return value, so the caller can
    work meanwhile."""

    def __init__(self, body, args=(), *, world: int = 4, init_file: str,
                 timeout: float = 120.0, backend: str = "gloo"):
        ctx = torch.multiprocessing.get_context("spawn")
        self.world, self.timeout = world, timeout
        self.out = ctx.Queue()
        # the body and its arguments go by a file beside the rendezvous: a
        # large argument through the spawn pipe holds each start until that
        # child has imported enough to read it, one child after another
        job = f"{init_file}.job"
        with open(job, "wb") as f:
            pickle.dump((body, args), f)
        self.procs = [ctx.Process(target=_entry,
                                  args=(r, world, init_file, backend, job,
                                        self.out),
                                  daemon=True) for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout

    def result(self):
        """Rank 0's result.  Raises ``RuntimeError`` with the first
        failing rank's traceback, or ``TimeoutError`` once the world has
        run ``timeout`` seconds; every process is gone when it returns."""
        try:
            try:
                status, result = self.out.get(
                    timeout=max(0.0, self.deadline - time.monotonic()))
            except queue.Empty:
                raise TimeoutError(f"a {self.world}-rank world did not "
                                   f"finish in {self.timeout} s") from None
            if status != "ok":
                raise RuntimeError(result)
            for p in self.procs:
                p.join(max(0.0, self.deadline - time.monotonic()))
            return result
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            self.out.close()


# ---------------------------------------------------------------------------
# the sharded-step cases (tests/test_torch_distributed.py)
# ---------------------------------------------------------------------------

LR = 1e-2


@functools.cache
def _mesh(shape):
    from repro_torch.launch.mesh import make_device_mesh
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                              "model")
    return make_device_mesh(shape, axes)


def _numpy(tree):
    from repro_torch.launch import sharding as shd
    return tree_map(lambda t: t.detach().cpu().numpy(), shd.gather(tree))


def _placement_report(tree, shardings) -> dict:
    """Local shapes against ``shard_shape`` and the gather against the
    whole leaf, leaf by leaf."""
    from repro_torch.launch import sharding as shd
    placed = shd.place(tree, shardings)
    whole = tree_leaves_with_path(tree)
    out = {"leaves": 0, "ragged": [], "not_bitwise": []}
    for (path, t), (_, p), (_, sh) in zip(
            whole, tree_leaves_with_path(placed),
            tree_leaves_with_path(shardings)):
        if not isinstance(t, torch.Tensor):
            continue
        out["leaves"] += 1
        if tuple(p.to_local().shape) != sh.shard_shape(tuple(t.shape)):
            out["ragged"].append(str(path))
        if not torch.equal(p.full_tensor(), t):
            out["not_bitwise"].append(str(path))
    return out


def _variant(rt, name: str):
    knobs = {"baseline": {}, "zero1": {}, "seq_parallel":
             {"seq_parallel": True}, "gqa_expand": {"gqa_expand": True}}
    return dataclasses.replace(rt, **knobs.get(name, {}))


def sharded_cases(cfg, weights, batch, cache, plan: dict):
    """Rank body: ``plan`` maps a mesh shape to the cases to run there —
    ``"place"``, ``"train": [variants]`` (``baseline``, ``zero1``,
    ``seq_parallel``, ``gqa_expand``, ``moe``: the reference's
    ``moe_shard_axes`` for the mesh's data axes; 3 steps each),
    ``"serve"`` (prefill logits of the batch's tokens, then one decode
    step a row of ``cache["tokens"]`` (T, B, 1) from ``cache["cache"]``)
    and ``"collectives"`` (a baseline and a ZeRO-1 step's collectives and
    local argument bytes), ``"ssd_heads"`` (:func:`_ssd_heads`);
    ``"window"`` sets the runtime's window there
    (the cache then a ring of that many slots).  ``weights`` (numpy, the
    reference's init), ``batch`` and ``cache`` (numpy) are the same on
    every rank.  Returns numpy results keyed by (mesh, case), and each
    case's seconds."""
    from repro_torch.fed import train_step as ts
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch import cost
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import data_axes
    from repro_torch.models.model import Runtime
    from repro_torch.optim import momentum

    opt = momentum(0.9)
    params = params_from_numpy(weights)
    tbatch = params_from_numpy(batch)
    out = {"seconds": {}}
    for shape, cases in plan.items():
        mesh = _mesh(shape)
        key = "x".join(map(str, shape))
        clock = [time.perf_counter()]

        def lap(name):
            now = time.perf_counter()
            out["seconds"][(key, name)] = now - clock[0]
            clock[0] = now

        rt0 = Runtime(attn_impl="naive", window=cases.get("window"))
        bsh = shd.batch_shardings(mesh, tbatch)
        if cases.get("place"):
            state = ts.TrainState(params, opt.init(params), 0)
            rep = {}
            for name, tree, sh in (
                    ("params", params, shd.params_shardings(mesh, params)),
                    ("state", state, shd.state_shardings(mesh, state)),
                    ("state_zero1", state,
                     shd.state_shardings_zero1(mesh, state)),
                    ("batch", tbatch, bsh)):
                rep[name] = _placement_report(tree, sh)
            if cache is not None:
                tcache = params_from_numpy(cache["cache"])
                rep["cache"] = _placement_report(
                    tcache, shd.cache_shardings(mesh, tcache))
            out[(key, "place")] = rep
            lap("place")
        for variant in cases.get("train", ()):
            rt = _variant(rt0, variant)
            if variant == "moe":
                rt = dataclasses.replace(rt, moe_shard_axes=data_axes(mesh))
            # place keeps a leaf's storage where it can and the step
            # writes in place: each run starts from its own copy
            state = ts.place_state(tree_map(torch.clone, params), opt, mesh,
                                   zero1=variant == "zero1")
            step = ts.make_train_step(cfg, rt, opt)
            db = shd.place(tbatch, bsh)
            losses, aux = [], []
            for _ in range(3):
                state, m = step(state, db, LR)
                losses.append(float(m["loss"]))
                aux.append(float(m["total_loss"] - m["loss"]))
            out[(key, "train", variant)] = {
                "loss": np.array(losses), "aux": np.array(aux),
                "params": _numpy(state.params)}
            lap(variant)
        if cases.get("serve"):
            out[(key, "serve")] = _serve(cfg, rt0, params, tbatch, cache,
                                         mesh)
            lap("serve")
        if cases.get("ssd_heads"):
            out[(key, "ssd_heads")] = _ssd_heads(mesh)
            lap("ssd_heads")
        if cases.get("collectives"):
            got = {}
            for zero1 in (False, True):
                state = ts.place_state(tree_map(torch.clone, params), opt,
                                       mesh, zero1=zero1)
                step = ts.make_train_step(cfg, rt0, opt)
                db = shd.place(tbatch, bsh)
                local = sum(t.to_local().numel() * t.element_size()
                            for _, t in tree_leaves_with_path([state, db])
                            if isinstance(t, torch.Tensor))
                _, _, coll = cost.count_sharded(step, state, db, LR)
                got[zero1] = {"local_bytes": local, "by_op": coll.by_op,
                              "count": coll.count}
            out[(key, "collectives")] = got
            lap("collectives")
    return out


def _ssd_heads(mesh) -> dict:
    """``sharded.ssd_on_local_heads`` on replicated DTensors against
    ``ops.ssd`` on the whole tensors, y and every gradient: with one group
    (B and C handed in as a copy for each rank, as the Mamba-2 mixer hands
    a group that several ranks read, the copies' gradients summed) and
    with as many groups as ``"model"`` has ranks (B and C split); and
    whether groups that ``"model"`` does not divide raise.  Returns the
    largest gap by group count and ``"raises"``."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import data_axes
    from repro_torch.models import sharded
    dm = mesh.device_mesh
    rep = [Replicate()] * dm.ndim
    gen = torch.Generator().manual_seed(5)
    b, s, h, p, n = 4, 32, 4, 8, 16
    m = mesh.shape["model"]
    out = {}
    for g in (1, m):
        ins = [torch.randn(b, s, h, p, generator=gen),
               0.1 + 0.5 * torch.rand(b, s, h, generator=gen),
               -0.5 - torch.rand(h, generator=gen),
               torch.randn(b, s, g, n, generator=gen),
               torch.randn(b, s, g, n, generator=gen)]
        dy = torch.randn(b, s, h, p, generator=gen)
        whole = [t.clone().requires_grad_() for t in ins]
        y = ops.ssd(*whole, chunk=16)
        y.backward(dy)
        k = m // g                     # the ranks that read each group
        handed = ins[:3] + [t.repeat_interleave(k, dim=2) for t in ins[3:]]
        parts = [distribute_tensor(t, dm, rep).requires_grad_()
                 for t in handed]
        yd = sharded.ssd_on_local_heads(*parts, chunk=16,
                                        rows=tuple(data_axes(mesh)))
        yd.backward(distribute_tensor(dy, dm, list(yd.placements)))
        grads = [t.grad.full_tensor() for t in parts]
        grads[3:] = [t.reshape(b, s, g, k, n).sum(3) for t in grads[3:]]
        out[g] = max(float((a - b_).abs().max()) for a, b_ in
                     [(yd.full_tensor(), y)] + [
                         (t, w.grad) for t, w in zip(grads, whole)])
    bad = [distribute_tensor(t, dm, rep) for t in (
        torch.zeros(b, s, 6, p), torch.ones(b, s, 6), -torch.ones(6),
        torch.zeros(b, s, 3, n), torch.zeros(b, s, 3, n))]
    try:                       # 3 groups over 2 ranks: a group straddles
        sharded.ssd_on_local_heads(*bad, chunk=16)
        out["raises"] = False
    except ValueError:
        out["raises"] = True
    return out


def sharded_jobs(jobs: dict):
    """Rank body: :func:`sharded_cases` for each ``name: (cfg, weights,
    batch, cache, plan)`` of ``jobs``, results by name."""
    return {name: sharded_cases(*job) for name, job in jobs.items()}


def _serve(cfg, rt, params, batch, cache, mesh) -> dict:
    """Prefill logits of ``batch`` and the logits of the decode steps of
    ``cache["tokens"]`` from ``cache["cache"]`` (its final state too)."""
    from repro_torch.fed import train_step as ts
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch import sharding as shd
    p = shd.place(params, shd.params_shardings(mesh, params))
    pre = {"tokens": batch["tokens"]}
    pre = shd.place(pre, shd.batch_shardings(mesh, pre))
    with torch.no_grad():
        logits = ts.make_prefill_step(cfg, rt)(p, pre)
        c = params_from_numpy(cache["cache"])
        c = shd.place(c, shd.cache_shardings(mesh, c))
        serve = ts.make_serve_step(cfg, rt)
        steps = []
        for tok in cache["tokens"]:
            t = {"t": torch.from_numpy(np.array(tok))}
            t = shd.place(t, shd.batch_shardings(mesh, t))["t"]
            lg, c = serve(p, c, t)
            steps.append(lg.full_tensor().numpy())
    return {"prefill": logits.full_tensor().numpy(),
            "decode": np.stack(steps), "cache": _numpy(c)}
