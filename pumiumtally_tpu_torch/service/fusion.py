"""Cross-session batch fusion (port of ``pumiumtally_tpu/service/fusion.py``):
the queued moves of several sessions share one device launch.

The worker hands ``run_group`` the head MOVES of sessions that the
scheduler grouped by fusion key (``PumiTally._fusion_key``: the same mesh
object, facade kind, dtype, device and static walk and scoring
configuration):

- each facade stages its move without changing its state
  (``_fused_move_stage``);
- the staged host buffers are packed into one slab per operand and
  uploaded once;
- ONE ``move_step`` / ``move_step_continue`` walks the slab (W0 on the
  card) with the segmented commit (``walk(tally_seg=)``): session k's
  particles tally at ``k*E + elem`` of a flux bank that concatenates the
  sessions' ``[E]`` fluxes, and with scoring its bin offsets are shifted
  by ``k*E*stride`` (a session-local DROP, ``>= stride``, remapped to the
  fused bank's end so that it still drops);
- each facade then adopts its slice (``_fused_move_commit``): flux and
  bank copied back into its own tensors, then the solo move's post-walk
  sequence (sentinel, counters, fence, timing, resilience hook).

Compatible ``StreamingTally`` sessions (one chunk grid, pinned by their
"stream" key) fuse chunk by chunk: one shared launch per chunk index
(``_pack_and_launch_stream``). The slab is not padded: the JAX package
rounds it to a power of two to bound its traces, which the port does not
have.

Determinism: a session's fused campaign is BITWISE its solo run. Every
session runs the deterministic commit (the service arms it,
``TallyService.open_session``), whose records are added per bank entry
in (step, particle) order; a session's particles keep their relative
order in the slab and its records land in its own segment, so each
segment sees the addition sequence of the session's solo walk
(tests/test_torch_fusion.py; on the card chip_smoke.py ``--service``).

Failure containment as in the JAX package: a session whose stage step
refuses (poisoned engine, move before source) gets the error on its
future and leaves the group; a failing shared launch re-runs the group
solo, with a warning, and is counted as a fallback; a failing commit
lands on that session's future while the others commit.
"""

from __future__ import annotations

import time
import warnings
from typing import List, Tuple

import numpy as np
import torch

from pumiumtally_tpu_torch.api.streaming import FusedStreamStage
from pumiumtally_tpu_torch.api.tally import move_step, move_step_continue
from pumiumtally_tpu_torch.service import staging


def _fused_move(rep, xs, elems, fluxes, banks, sbins, sfacs, dests, fly, w,
                origins, *, spans, use_committed):
    """ONE launch for K sessions' head moves over the packed slab
    (``dests``, ``fly``, ``w``, ``origins`` device tensors of sum(spans)
    rows; ``origins`` None when every session continues). The sessions'
    committed state (``xs``, ``elems``, ``fluxes``; with scoring
    ``banks``, ``sbins``, ``sfacs``) is concatenated here. ``rep`` is
    the representative facade: its key pinned the mesh and the statics.
    Returns one ``(x, elem, flux, done, s, bank or None)`` slice per
    session."""
    E = fluxes[0].numel()
    K = len(spans)
    dev = rep.device
    x = torch.cat(xs)
    elem = torch.cat(elems)
    flux = torch.cat(fluxes)
    seg = torch.cat([torch.full((n,), k * E, dtype=torch.int32, device=dev)
                     for k, n in enumerate(spans)])
    scoring = None
    stride = 0
    if banks is not None:
        stride = rep._scoring.stride
        bank = torch.cat(banks)
        drop = K * E * stride
        sbin = torch.cat([
            torch.where(sbins[k] >= stride,
                        torch.full_like(sbins[k], drop),
                        sbins[k] + k * E * stride)
            for k in range(K)])
        scoring = (rep._scoring.spec.kinds, bank, sbin, torch.cat(sfacs))
    kw = dict(tol=rep._tol, max_iters=rep._max_iters, scoring=scoring,
              deterministic=rep._deterministic, tally_seg=seg)
    if all(use_committed):
        # Every session continues from its committed state: phase B only,
        # as each solo move.
        x2, elem2, done, s_b = move_step_continue(
            rep.mesh, x, elem, dests, fly, w, flux, **kw)
    else:
        # A session without staged origins walks phase A from its
        # committed positions to themselves: zero distance, (x, elem)
        # unchanged, as its solo continue move.
        parts, a = [], 0
        for k, n in enumerate(spans):
            parts.append(xs[k] if use_committed[k] else origins[a:a + n])
            a += n
        x2, elem2, done, s_b = move_step(
            rep.mesh, x, elem, torch.cat(parts), dests, fly, w, flux, **kw)
    out, a = [], 0
    for k, n in enumerate(spans):
        out.append((
            x2[a:a + n].clone(), elem2[a:a + n].clone(),
            flux[k * E:(k + 1) * E], done[a:a + n], s_b[a:a + n],
            None if scoring is None
            else scoring[1][k * E * stride:(k + 1) * E * stride]))
        a += n
    return out


def _run_solo(live) -> bool:
    """Run staged but not launched moves one at a time through the
    facade (the stage step changed nothing, so ``MoveToNextLocation``
    runs cleanly), with the worker's containment
    (``staging.run_op_contained``)."""
    drain = False
    for sess, op, _st in live:
        drain = staging.run_op_contained(sess.tally, op) or drain
    return drain


def run_group(items: List[Tuple]) -> Tuple[bool, int, int, bool]:
    """Run one fused group: ``items`` are ``(session, StagedOp)`` move
    heads sharing one fusion key. Resolves every op's future (None, as a
    solo move, or its own exception). Returns ``(drain, coalesced,
    solo_ran, fell_back)``: a facade's resilience hook asked for a
    drain; the moves that went through the ONE shared launch; the moves
    run one launch at a time; whether the shared launch failed and the
    group ran solo."""
    t0 = time.perf_counter()
    live = []
    for sess, op in items:
        try:
            st = sess.tally._fused_move_stage(op)
        except BaseException as e:  # noqa: BLE001 — that session's own
            # refusal; the rest still fuse.
            op.future.set_exception(e)
        else:
            live.append((sess, op, st))
    if not live:
        return False, 0, 0, False
    if len(live) == 1:
        return _run_solo(live), 0, 1, False
    chunked = isinstance(live[0][2], FusedStreamStage)
    try:
        if chunked:
            outs, devs = _pack_and_launch_stream(live)
        else:
            outs, devs = _pack_and_launch(live)
    except BaseException as e:  # noqa: BLE001 — a failed shared launch
        # must not take K sessions down when each op can still run solo.
        warnings.warn(
            f"fused launch failed ({type(e).__name__}: {e}); "
            "re-executing the group unfused"
        )
        return _run_solo(live), 0, len(live), True
    drain = False
    a = 0
    for k, (sess, op, st) in enumerate(live):
        try:
            s_ops = None
            if chunked:
                if sess.tally._sentinel is not None:
                    C = sess.tally.chunk_size
                    lo = k * C
                    s_ops = [(None if st.origins is None
                              else org[lo:lo + C], d[lo:lo + C],
                              f[lo:lo + C], wv[lo:lo + C])
                             for (d, f, wv, org) in devs]
            elif sess.tally._sentinel is not None:
                n_k = sess.tally.num_particles
                dests, fly, w, org = devs
                s_ops = (st.x_prev if st.origins is None
                         else org[a:a + n_k], dests[a:a + n_k],
                         fly[a:a + n_k], w[a:a + n_k])
            sess.tally._fused_move_commit(outs[k], st, t0, s_ops)
        except SystemExit as e:
            op.future.set_exception(e)
            drain = True
        except BaseException as e:  # noqa: BLE001 — one session's
            # failing commit must not cost the others their results.
            op.future.set_exception(e)
        else:
            op.future.set_result(None)
        if not chunked:
            a += sess.tally.num_particles
    return drain, len(live), 0, False


def _slab(parts, device) -> torch.Tensor:
    """The sessions' host buffers as one slab: one concatenation and one
    upload."""
    return torch.from_numpy(np.concatenate(parts)).to(device)


def _pack_and_launch(live):
    """Pack the staged host buffers into one slab per operand (one host
    concatenation and one upload each), then the fused launch. Returns
    the per-session slices and the slab tensors (the sentinel's commits
    slice them)."""
    rep = live[0][0].tally
    dev = rep.device
    wd = live[0][2].dests.dtype
    spans = tuple(sess.tally.num_particles for sess, _op, _st in live)
    stages = [st for _sess, _op, st in live]
    dests = _slab([st.dests for st in stages], dev)
    fly = _slab([st.fly if st.fly is not None else np.ones(n, np.int8)
                 for st, n in zip(stages, spans)], dev)
    w = _slab([st.w if st.w is not None else np.ones(n, wd)
               for st, n in zip(stages, spans)], dev)
    use_committed = tuple(st.origins is None for st in stages)
    org = None
    if not all(use_committed):
        org = _slab([st.origins if st.origins is not None
                     else np.zeros((n, 3), wd)
                     for st, n in zip(stages, spans)], dev)
    tallies = [sess.tally for sess, _op, _st in live]
    scoring = rep._scoring is not None
    outs = _fused_move(
        rep, [t.x for t in tallies], [t.elem for t in tallies],
        [t.flux for t in tallies],
        [t._score_bank for t in tallies] if scoring else None,
        [st.sbin for st in stages] if scoring else None,
        [st.sfac for st in stages] if scoring else None,
        dests, fly, w, org, spans=spans, use_committed=use_committed)
    return outs, (dests, fly, w, org)


def _pack_and_launch_stream(live):
    """The chunk-wise pack: one fused launch PER CHUNK INDEX (every
    session's chunk j in one slab); chunk j's launch is issued before
    chunk j+1 is packed on the host. Returns per-session lists of chunk
    slices (``outs[k][j]``) and the per-chunk slab tensors."""
    rep = live[0][0].tally
    dev = rep.device
    K = len(live)
    C = rep.chunk_size
    spans = (C,) * K
    stages = [st for _sess, _op, st in live]
    tallies = [sess.tally for sess, _op, _st in live]
    use_committed = tuple(st.origins is None for st in stages)
    scoring = rep._scoring is not None
    outs = [[] for _ in range(K)]
    devs = []
    for j in range(rep.nchunks):
        dests = _slab([st.dests[j] for st in stages], dev)
        fly = _slab([st.fly[j] for st in stages], dev)
        w = _slab([st.w[j] for st in stages], dev)
        org = None
        if not all(use_committed):
            org = _slab([st.origins[j] if st.origins is not None
                         else np.zeros((C, 3), st.dests[j].dtype)
                         for st in stages], dev)
        chunk_outs = _fused_move(
            rep, [t._x[j] for t in tallies], [t._elem[j] for t in tallies],
            [t._flux[j] for t in tallies],
            [t._score[j] for t in tallies] if scoring else None,
            [st.sbin[j] for st in stages] if scoring else None,
            [st.sfac[j] for st in stages] if scoring else None,
            dests, fly, w, org, spans=spans, use_committed=use_committed)
        for k in range(K):
            outs[k].append(chunk_outs[k])
        devs.append((dests, fly, w, org))
    return outs, devs
