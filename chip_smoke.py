#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --w0-times      # W0's times alone, no checks
    python3 chip_smoke.py --w3-g1-times   # W3's and G1's, no checks
    python3 chip_smoke.py --staging-times # PumiTally's staging, no checks
    python3 chip_smoke.py --scoring-times # the scoring commit's, no checks
    python3 chip_smoke.py --w4-times      # W4's times, any checkout
    python3 chip_smoke.py --unpacked-sentinel  # this layout's phases alone
    python3 chip_smoke.py --resilience    # phase 14 alone, with its checks
    python3 chip_smoke.py --det-times     # DC alone by regime, any checkout
    python3 chip_smoke.py --service       # W0's segmented commit and the
                                          # service phase, with checks
    python3 chip_smoke.py --native        # phase 16 alone, with checks
    python3 chip_smoke.py --multi-device  # phase 17 alone, with checks
    python3 chip_smoke.py --edges         # phase 18 alone, with checks

Without a CUDA device every mode exits non-zero before it does anything
else. Every mode runs inside the chip lock (utils/chiplock.py: by
default a file in the temporary directory, or the one that
PUMIUMTALLY_CHIP_LOCK names, as the JAX package's tools read it),
waiting at most CHIP_LOCK_WAIT_S for another holder and exiting
non-zero, naming the lock, when it stays busy; its child processes
inherit the window. The full run and ``--edges`` run under
``utils.profiling.build_guard`` (each library built at most
config.BUILD_BUDGET times) and print a ``# builds`` line: no library may
be built after phase 2, and in the full run each is loaded once.

Phases, in order; any failure raises and the script exits non-zero:

1. Device: the card's name, and its name and power limit as nvidia-smi
   reports them.
2. Build: every kernel of the port, compiled from csrc/ with nvcc for
   sm_90a (build seconds and the ptxas register/shared-memory report;
   W0's registers and spills on a line of their own, per instantiation:
   float / double, packed / two-tier / ROW16 / ROW20, scoring off / on).
   From ``cuobjdump -sass`` (required): every unpacked instantiation
   loads its planes as 128-bit words (at least 5 in float32; 9 ROW16,
   10 ROW20 in float64) and no narrower global load beyond the packed
   instantiation's with the same flags (``phase_plane_loads``).
3. W0 (csrc/walk.cu) against its plain PyTorch version ``walk_plain`` on
   the card: a 48,000-tet box, 500,000 particles on bench.py's random
   trajectory, float32, tallying. The kernel counts the particles it
   walked, which must be all of them, and its time, tallying and not,
   stands beside the crossings per second and the SM cycles per
   crossing. Then W0's ``skip`` flag (the move's device-side phase-A
   skip) on both tiers: set, it walks no particle and returns its
   inputs bitwise, as ``walk_plain(skip=...)`` does; clear, it walks
   all.
4. W1 (csrc/block_walk.cu) against ``vmem_walk_local_plain``: the same
   mesh sub-split into blocks of at most 1024 elements, every tallied
   round of the first move (round 1; round 2 is round 1's output after
   the engine's own ``_migrate``; and so on while particles pause at
   block faces), rounds 1 and 2 timed (device time from torch.profiler,
   CUDA events beside it) against each round's bytes bound. The kernel
   counts how many of its CUDA blocks found no active slot, walked with
   rows from global memory, or staged the table in shared memory by
   TMA, and the slots it walked and wrote out idle: each round must
   walk every active slot and write out every idle one, W1 must have
   staged and found empty shares, and never read rows from global
   memory.
4b. W4 (csrc/gather_block_walk.cu, the gather block walk) against
   ``walk_local_blocks_plain`` on every tallied round of the first
   move, each round's input migrated by the engine's ``_migrate``, the
   occupied-block list carried as the engine carries it: the box as one
   block (the partitioned facades' default configuration), the gather
   sub-split (47 blocks of <= 1,024), the same with the int32 sidecar,
   the bf16 tables with the vmem knobs (rerouted: 24 blocks), float32
   scoring with the stride-96 spec on one block and on the sub-split,
   the bf16 reroute with scoring, and float64 on one block (100,000
   particles), the box as one block on the two-tier tables, and (with
   the lattice's phases) the lattice as one block (100,000 particles).
   Ids, masks, pending and iters equal, positions bitwise, flux at rtol
   1e-4, lanes as 6b; the blocks walked must be those holding a
   not-done slot, one launch a round. Each round also runs the engine's
   in-place call on the round's work list (round 1: no list; later
   rounds: the list built from ``done``), equal to the plain version,
   the kernel's count of walked slots equal to the list's length. Those
   calls timed, W4's kernels with their list builds, rounds 1 and 2
   (four passes into standing buffers; one block also untallied) and
   the whole move's rounds, beside their bytes bound (``w4_bytes``) and
   the plain version. Then W4's list build against its plain version,
   timed beside its bound and ``torch.argsort``, and W4 on a block list
   past 65,535 blocks (the box's 750-block sub-split, its round-1 input
   stacked 94 times, every 16th block left off the list), in one
   launch, against the plain version.
5. W0's two-tier variant (csrc/walk.cu, bf16 select + f32 refinement
   tables) against the two-tier ``walk_plain``, as phase 3; then W0 in
   float64 on the box (100,000 particles) against ``walk_plain``.
5b. W0's unpacked entries (``walk_unpacked``, ``walk_unpacked_scored``:
   ROW16, the planes in one [E,16] buffer and the int32 ids in
   ``face_adj``) on the box in the forced unpacked layout, float32
   (500,000 particles) and float64
   (100,000), against ``walk_plain`` (ids, masks, iters, x and s
   bitwise, flux rtol 1e-4, lanes as 6b, every particle walked) and
   against the packed W0 on the same inputs (x, s bitwise, ids equal),
   flux conserved at rtol 1e-6; both entries timed in turns with the
   packed W0 (CUDA events, four passes) beside the bound. The same for
   its other caller, a two-tier mesh walked at ``table_dtype="float32"``
   (the sentinel's rung 2: the planes read in place from
   ``walk_table_hi`` at stride 5), against ``walk_plain`` on
   ``with_plane_views()`` and the packed W0 on ``with_packed_table()``,
   float32 and float64 (ROW20). The same on the lattice with phase 11.
6. W2 (csrc/twotier_block_walk.cu) against ``pallas_walk_local_plain``
   as phase 4, in both regimes: 24 blocks of <= 2,000 elements (the bf16
   tier doubles the 1024 bound; rows may be staged in shared memory),
   and one block of all 48,000 (rows read from global memory, one
   round); the first must stage and find empty shares, the second read
   global rows, so the three per-CUDA-block regimes all run.
6b. The scoring slice's kernels, with the stride-96 spec (an energy
   filter of 8 bins, a time filter of 4, the scores flux, heating and
   events; 1% of the energies out of range, dropped): the registers of
   every W0 and W2 instantiation, the scoring-off ones equal to the
   counts before scoring existed (REGS_BEFORE_SCORING), beside the
   vector and scalar global float reductions in its SASS (``cuobjdump``,
   required: the float32 scoring instantiations must show vector
   reductions, the scoring commit's cover, and no other any); W0's scoring
   instantiation on both tiers (and in float64) against
   ``walk_plain(scoring=)``, and W2's in both regimes on every round of
   the first move against ``pallas_walk_local_plain(scoring=)``: ids,
   masks, iters, positions and s bitwise, and equal to the same
   kernel's scoring-off run; flux at rtol 1e-4 of its largest element,
   each track lane at rtol 1e-4 of its own value, the event lanes equal
   and whole; scoring-on and scoring-off kernel times (into standing
   buffers; W0 by CUDA events, W2 by torch.profiler) in turns, four
   passes each, beside the bytes bound (each bank lane the run touched
   read and written once, each particle's bin offset and factors read
   once). On the box's packed float32 walk, the count of crossings that
   share (warp share, element, bin) with another at the same step
   (``experiments/score_collisions.py``).
6c. The scoring commit's edge cases: specs of S = 1, 2 and 3 scores
   over 3 energy bins (strides 3, 6, 9) through W0 on both tiers in
   float32 and float64 and W2 in both regimes (rounds 1-2), against
   their plain versions as in 6b, with 64 particles (W2: active slots
   of the last block) walking out of the last element in its last bin,
   so the plain run must touch the last lane of that row (the bank's
   last lane: the row-boundary split and W0's DROP limit); every
   float32 kernel also runs on a bank that starts one lane past its
   allocation's 16-byte alignment.
7. W3 (csrc/resident_walk.cu) through its experiment entry point
   (``experiments/r3_vmem.py`` bench: the L sweep of
   tools/exp_r3_vmem.py with W3 and W0, launches counted over it), its
   SASS summarised (``cuobjdump -sass``: global and shared loads,
   atomics; one instance per regime, the shared-adjacency one with one
   global load fewer), then at each L = 750, 1,296, 2,058, 3,072
   (neighbour ids in shared memory) and 3,360 (ids read from global
   memory; each cell's L and regime asserted, both regimes run),
   500,000 particles on the tool's trajectory, against
   ``walk_vmem_plain``: the kernel's count of walked particles must be
   all of them, and its time stands beside the entry point's time a
   call, W0's on the same input, the SM cycles per crossing and the
   lanes' busy share (crossings / (32 x warp steps)).
8. G1 (csrc/row_gather.cu) through its experiment entry point
   (``experiments/pallas_gather.py``, both probes, launches counted over
   them), then both fill modes against ``gather_plain`` at the probes'
   shape (8,192 rows of [48000,32] f32) and at 500,000 rows, on in-range
   indices and on wrapped and out-of-range ones, with its bound,
   ``torch.index_select`` as the yardstick (nothing in the port calls
   it), an empty kernel, a fill of the output and a contiguous device
   copy of as many rows. The bound counts each distinct table row the
   indices name once.
9. Oracle: the reference's 6-tet unit-cube oracle in float64 through
   both facades on the card, held at 1e-8.
10. Main paths at bench.py's size (48,000 tets, 500,000 particles):
   ``PumiTally`` and ``PartitionedPumiTally`` on the float32 table, then
   both on the two-tier tables (``walk_table_dtype="bfloat16"``; the
   partitioned one with ``walk_kernel="pallas"``). Each:
   CopyInitialPosition, one two-phase move, then continue moves;
   track-length conservation at rtol 1e-6; WriteTallyResults; its
   kernels' launch counts > 0 in that run; moves/s; then one more
   continue move under torch.profiler: wall time, device-busy time, the
   kernels that take it and, on the partitioned facade, the block
   walk's kernel time in each round, its launches per move and their
   sum. A two-tier run's flux stays within the
   JAX package's tie-class band of the float32 run's (L1 < 1e-2 of the
   total track length, tests/test_walk_twotier.py). Then
   ``PartitionedPumiTally`` with a default config (one block, W4) and
   with the bf16 tables and the vmem knobs (W4 two-tier) through the
   same main path, a ``PhaseProfile`` of a default continue move,
   ``cap_frontier=4096`` against the default on one block and on the
   gather sub-split (positions and ids equal), and a forced overflow
   (100,000 particles into one corner, capacity_factor 1.3) that the
   recovery ladder completes with conservation.
10b. Staging (500,000 particles, box): with ``check_found_all=False,
   fenced_timing=False`` an echoing two-phase move and a continue move
   run under ``torch.cuda.set_sync_debug_mode("error")`` behind ~50 ms
   of queued device work and must return while it still runs; the
   protocol with the echo on and off, fenced and not (and unvalidated)
   gives bitwise positions, equal ids and flux within rtol 1e-4.
10b'. Scoring without a host sync: an unfenced, unchecked continue move
   with scoring (energy and time staged, bins resolved on the device)
   under ``set_sync_debug_mode("error")`` behind ~50 ms of queued device
   work must return while it still runs.
10b''. The unpacked layout through ``PumiTally``'s main path (the box,
   scoring on: localization and phase A on ``walk_unpacked``, phase B
   on ``walk_unpacked_scored``), conservation. The straggler ladder
   (``TallyConfig(max_iters=2, sentinel=SentinelPolicy())``, point
   location first) on ``PumiTally`` (float32: ids and positions bitwise
   vs an unconstrained run; two-tier with rung 1 starved so that rung 2,
   ``walk_unpacked`` over the refinement tier, recovers everyone:
   positions bitwise, ids counted; and against the same ladder with its
   rungs on ``walk_plain``: positions and ids equal, flux rtol 1e-4),
   the default ``PartitionedPumiTally``
   (W4's resumed phase: positions bitwise, a differing id must name a
   tet that holds its position) and ``StreamingTally`` (chunks of
   100,000: bitwise ids), each with every straggler recovered and flux
   totals at rtol 1e-6; a ladder starved to one step writes one
   quarantine record per lost particle; an audited unfenced continue
   move makes exactly one synchronizing call (the audit's fetch;
   sentinel-off none), its ms in turns with sentinel-off.
   ``intersection_points()`` at 500,000: a particle that stayed in its
   tet returns its start, the others a point on a face plane of their
   final element (1e-5).
10c. The streaming cell: 10,000,000 particles in 1,000,000-particle
   chunks on the box, ``StreamingTally`` on both tiers and
   ``StreamingPartitionedTally`` (W1) beside ``PumiTally`` on both
   tiers, in lockstep on bench.py's trajectory generated a move at a
   time (CopyInitialPosition, one two-phase move, continue moves; the
   partitioned one stops after one). Streaming vs monolithic: ids
   equal, positions bitwise, flux at rtol 1e-4; each conserving at rtol
   1e-6; the partitioned ids equal but for face ties; moves/s; then one
   profiled streaming move: idle share and the host-to-device copy time
   that overlaps kernel time, which must be > 0 (the double buffer).
11. The 3x3 pincell assembly (FLAGSHIP_PINCELL cells, 60 layers:
   984,960 tets), written with the port's ``write_osh`` into a
   temporary directory: W0 on both tiers against its plain version on
   that mesh (first move, beside the box's), then ``PumiTally`` built
   from the ``.osh`` path on both tiers through the main path of phase
   10 on bench.py's trajectory over the assembly's box. The two-tier
   flux is held to conservation and its L1 against the float32 flux
   reported (on this geometry the select tier moves more track length
   than the box's tie band, in the JAX package too).
   Then W0's scoring instantiation on both tiers on the lattice, as in
   phase 6b, and ``PartitionedPumiTally`` with a default config (one W4
   block of 984,960 tets) from the path through the main path with
   100,000 particles (cut: its point location is brute force, O(N*E)).
12. The scoring slice's main path: ``PumiTally`` on both tiers on the
   box and on the lattice (from its path), ``PartitionedPumiTally`` on
   W2, ``StreamingTally`` at 10M (float32) and
   ``StreamingPartitionedTally`` (W2, 10M, one two-phase move a batch),
   each with the spec and ``batch_stats=True`` over 3 batches
   (CopyInitialPosition, a two-phase move, continue moves, energies all
   in range), launch counts reset before each and read after:
   conservation at rtol 1e-6, the flux score summed over bins against
   the flux lane at rtol 1e-4, the event lanes whole, ``rel_err``
   finite where flux > 0, the score and statistics arrays written by
   WriteTallyResults; one profiled continue move with scoring of the
   box ``PumiTally`` on both tiers and of ``PartitionedPumiTally`` (its
   block walk's time in every round and their sum); and
   ``PartitionedPumiTally`` with scoring on W4: the default config and
   the bf16 tables with the vmem knobs (box, 500,000 particles, one
   profiled continue move of the default).
12b. A mesh past the float lanes' exact ids: ``box_arrays(1, 1, 1,
   142, 142, 142)``, 17,179,728 tets in float32, built with no flag
   (unpacked), through ``PumiTally`` at 500,000 particles: localization
   by walk, a two-phase and two continue moves, conservation at rtol
   1e-6 after each, the last move's walk against ``walk_plain`` on the
   card, then that walk's kernel timed (CUDA events, four passes) beside
   its bound (the tets it crosses read once) and its SM cycles a
   crossing; the host build's seconds and peak memory, the device table
   bytes, each move's ms.
14. The deterministic commit (csrc/det_commit.cu, DC) and the resilience
   layer. W0's deterministic instantiation (packed, two-tier, unpacked
   ROW16 and ROW20, scoring) and W4's (one block, the gather sub-split
   with its round 2 over the work list, two-tier, scoring) on the box,
   float32 at 500,000 particles and float64 at 100,000: two launches on
   the same inputs equal bitwise, flux and lanes; equal bitwise to the
   plain version on the card (``walk_plain`` / ``walk_local_list_plain``
   with ``deterministic=True``: their records through
   ``det_commit_plain``),
   positions, ids and flags too; equal bitwise to the plain version on
   the CPU (its serial ``index_add_``, one thread) on the float64 cells
   and W0's packed float32 cell; flux conserved at rtol 1e-6; a walk
   into record streams of 1,024 records (overflowed, grown and made
   again, W4's in-place rows put back) equal to it bitwise. Per
   float32 cell, a move with the deterministic commit against the
   atomic one in turns (CUDA events, four passes), and DC alone on the
   cell's flux records, bitwise against ``det_commit_plain``, beside its
   bound, the plain version and ``index_put_(accumulate=True)`` under
   ``torch.use_deterministic_algorithms(True)``. Then the contract:
   ``PumiTally``, ``StreamingTally`` (chunks of 250,000) and the default
   ``PartitionedPumiTally`` at 500,000 particles with a
   ``CheckpointPolicy`` (autosave every batch) over 3 batches of 2
   continue moves: two runs bitwise (flux, positions, ids), a run saved
   mid-batch and resumed into a fresh facade bitwise, and a drain arm in
   subprocesses (``PUMIUMTALLY_FAULT=sigterm@batch:2``, exit 0, then
   ``--resume``) bitwise; the seconds to save and to resume, and a
   move's wall ms with the policy against the same campaign without
   one; ``walk`` / ``gather_block_walk`` and ``det_commit`` launched.
   The W0 registers check of 6b also holds the deterministic
   instantiations to no float reduction at all. DC alone on seeded
   cells (``DC_CELLS``): one hot key (which must take the over-full
   path, float32 and float64), m below one tile, K = 1, K = TK + 1,
   20M uniform keys over 4.6M lanes, float64, a 300M-entry bank (key
   groups), each bitwise against ``det_commit_plain``. The block walks' kDet
   instantiations (W1, W2, W2 with scoring lanes) on round 1 of the
   sub-split's first move, float32 at 500,000 and float64 at 100,000:
   bitwise against their plain versions on the card, across two launches
   and after their record streams regrew, timed against the atomic form
   in turns; and their facades' campaigns (two runs, a mid-batch resume:
   bitwise).
15. The service. W0's segmented commit (``walk(tally_seg=)``): 8
   sessions of 62,500 particles and a walking padding row at 8*E, on
   the packed and two-tier tables, with scoring, and on both unpacked
   layouts (ROW16, ROW20): the atomic form's
   positions bitwise its plain version and flux at rtol 1e-4, the kDet
   form bitwise, each segment conserving its own sessions' track. Then
   ``TallyService`` over 10 sessions of 100,000 particles on the box
   (6 ``PumiTally``, 1 with scoring and a sentinel, 2 ``StreamingTally``
   in chunks of 50,000, 1 default ``PartitionedPumiTally``), 3 batches
   of 2 moves: every session bitwise its solo replay and the
   ``fuse_sessions=False`` run, the fused groups 6 and 2 wide, no
   fallback; served moves/s fused and not, dispatches a move, the
   fused launch's ms and DC's share. Then a ``SocketFrontend`` on
   127.0.0.1 under ``tools/loadgen.py`` (32 clients of 10,000
   particles): every client served, two clients' fluxes bitwise their
   solo replays.
16. The C ABI and the CLI: the port's ``libpumiumtally_c.so`` and its
   hosts built (``native/build.py``); the 48,000-tet box written as
   ``.msh`` by the CLI's ``box`` verb; the library loaded into this
   interpreter through ctypes and each engine (mono, streaming at
   250,000 a chunk, partitioned, streaming_partitioned) driven through
   it with the default device and dtype: 500,000 particles, three
   two-phase moves and one continue, conservation at rtol 1e-6, each
   engine's kernel launched (W0; W4 for the partitioned ones), its
   facade on cuda; mono also against a ``PumiTally`` built here on the
   same calls (positions and ids bitwise, flux rtol 1e-4). Then the
   hosts as subprocesses with no PUMIUMTALLY_ switch but the dtype:
   ``test_host`` on the 6-tet cube in float64 (the reference's oracle
   at 1e-8; ``--corrupt`` must fail). Then 500,000 x 6 two-phase moves
   on one protocol in three arms, two passes in turns: ``bench_host``
   (a C host), the same loop through ctypes in this process, and the
   Python facade; for the last two the host ms of each call beside the
   ms inside ``PumiTally.MoveToNextLocation``.
   The CLI's ``aot-check`` (every kernel and the C ABI compiled again,
   beside the in-process runs) must report ``[OK]``.
17. Multi-device (``phase_multi_device``): (a) ``PumiTally`` and
   ``StreamingTally`` on a mesh of 4 logical shards of cuda:0 against
   the one-device facades (positions and ids bitwise, flux rtol 1e-5,
   conservation, W0 launched 4 times a walk; two runs bitwise under a
   ``CheckpointPolicy``); (b) ``PartitionedPumiTally`` on the 4 shards
   (W4 by default, W1, W2) against one device (positions bitwise, ids
   only at face ties, conservation, every shard launching its walk, a
   ``PhaseProfile``d move), each captured migration round bitwise the
   one-device migrate by both in-process paths (timed in turns), and
   the collective's engine path bitwise the row copies, two runs
   bitwise, under DC; (c) ``StreamingPartitionedTally``
   with ``device_groups=2`` at 2,000,000 particles in chunks of 500,000
   (cut from 10M: brute-force point location); (d) two processes of 2
   shards over gloo, bitwise the one-process run, with the backend and
   the host copies a migration printed. ms a move at 4 shards and at 1.
18. The edges (``phase_edges``): (a) (run right after phase 2, before
   any other profiler window) one continue move of ``PumiTally``
   on the box at 500,000 particles under ``utils.profiling.trace``: the
   Chrome trace it writes names W0's kernel among its device events,
   and ``phase_timer``'s fenced reading of the move is no less than its
   device time from CUDA events (W0's start less its launch printed);
   late, after phase 17, two more traced moves and one padded with
   TRACE_PAD_MS of host time at each end of its window, read and
   reported, never failed on: such a late window can keep no device
   event (ROADMAP queue 3); (b) the three examples through their
   ``main`` at their default sizes: openmc_style_driver in every mode
   and protocol and part mode at ``--vmem-bound 200`` (W0, W4 and W1
   launched; float64 conservation at 1e-6), multi_client_service (both
   sessions bitwise their serial runs), multichip_checkpointed_run (4
   logical shards of cuda:0: the checkpoint and one piece a shard).
19. One JSON line with each kernel's launches, times, bound and error
   (W0, W2 and W4's instantiations as entries of their own, DC on the
   packed float32 W0 cell's flux records, the block walks' kDet forms,
   W0's segmented commit), then the card's name and power limit, then
   the result line.

Kernel comparisons: element ids, done/exited/pending masks and ``iters``
must be equal; positions and ray coordinates are expected bitwise equal
(both sides build with no fused multiply-add): W1 holds them at 1e-6
absolute in float32, W0 (both tiers, both dtypes), W2, W3 and W4 bitwise; flux
sums in another order (float atomics) and is held at rtol 1e-4. G1 moves
values without arithmetic and is held bitwise, NaN fills by position.

``--w0-times`` runs phases 1-2, then prints W0's times (tallying and
not, crossings, SM cycles per crossing) on the box and the lattice, on
both tiers, one JSON line a cell; then the unpacked cells, one JSON line
each (``w0_unpacked_cells``): on the box and the lattice, float32 and
float64, W0 on the packed table, on ``TetMesh.from_arrays(...,
force_unpacked=True)`` and on the two-tier tables at
``walk(table_dtype="float32")``, in turns (four passes), float32 also
with the stride-96 scoring spec; and the 17,179,728-tet box's continue
walk (``w0_large_cell``), each arm beside its bound and SM cycles per
crossing. It calls only what every checkout of the port with the
unpacked layout has (``PumiTally``, ``TetMesh.from_arrays``, the ``walk``
wrapper, the plain steps), so a copy of this file in another checkout
times that checkout: an A/B of two trees runs each tree's copy in turn
(parent, change, change, parent).

``--w3-g1-times`` runs phases 1-2, prints the SASS summaries of W3 and
G1, then one JSON line a cell: W3 at each L of phase 7 (kernel ms over
four profiled passes, the entry point's ms a call, W0's ms, crossings,
SM cycles per crossing, the lanes' busy share where the checkout's
``walk_vmem`` takes ``counts``, the bound), G1 at both row counts in
both fill modes (microseconds over four passes, the bound,
``index_select``, the empty kernel, the output fill and the copy). It calls only ``r3_vmem.setup``, ``r3_vmem.walk_vmem``, ``walk``
and ``pallas_gather.gather``, so a copy times another checkout as
``--w0-times`` does.

``--w4-times`` runs phases 1-2, then one JSON line a cell with W4's
device ms over four passes as the engine runs each round (W4's kernels,
the list builds included, the walk alone, and every activity of the
call) beside the bound: the box as one block tallied, untallied, on the
two-tier tables and with scoring, the 47-block sub-split's rounds 1 and
2 and whole first move, and the lattice as one block (100,000
particles); in a checkout with ``walk_local_list``, a line for each arm
of the first round's list (no list, element order by a torch sort),
then W4 over an empty list of the slot count's capacity (what the
CUDA blocks past a list's length cost), on the one-block cells and the
sub-split's round 1. It calls only ``PartitionedEngine``,
``walk_local`` and ``TallyConfig`` where the checkout has nothing newer,
so a copy times another checkout, as ``--w0-times`` does.

``--staging-times`` runs phases 1-2, then ``PumiTally`` at 500,000
particles on the box in bench.py's protocols (``two_phase``: origins
echo the previous destinations; ``two_phase_forced``: the same with
``auto_continue=False``, where the checkout's config has the field;
``continue``), each with the default knobs and, where the fields exist,
``validate_inputs=False, fenced_timing=False``: one JSON line an arm
with moves/s, the calls' host ms a move and the device-busy ms of a
profiled move, four passes each. It calls only ``PumiTally``,
``TallyConfig`` and ``build_box``, so a copy times another checkout.

``--scoring-times`` runs phases 1-2, then one JSON line a cell with
the scoring commit's kernel times, no checks: W2's rounds 1 and 2 in
the shared regime and its global regime (torch.profiler), W0 on both
tiers on the box and the lattice (CUDA events), each scoring off, on
(the stride-96 spec) and on with the padded layout (stride 4B, bin
offset 4b: every bin's lanes in one 16-byte quad; not the port's
layout), SCORE_PASSES passes in turns, into standing buffers. It calls
only what every checkout of the port with scoring has, so a copy times
another checkout, as ``--w0-times`` does.

``--unpacked-sentinel`` runs phases 1-2, the scoring instantiations'
registers, 5b on the box, 10b'' and 12b, with their checks.

``--resilience`` runs phases 1-2, the instantiations' registers and
phase 14, with their checks (``--resilience-campaign`` is its drain
arm's subprocess).

``--service`` runs phases 1-2 and phase 15 (W0's segmented-commit cells
and the service), with their checks.

``--native`` runs phases 1-2 and phase 16 (the C ABI and the CLI), with
their checks.

``--multi-device`` runs phases 1-2 and phase 17 (multi-device), with
their checks; ``--multi-device-rank R PORT OUT`` is one rank of its
two-process job.

``--edges`` runs phases 1-2 and phase 18 (utils/profiling.py and the
examples), with their checks, under ``build_guard``.

``--det-times`` runs phases 1-2, then DC alone on the records of the
deterministic walks (the box's W0 move, flux and stride-96 lanes; the
lattice's flux; the service's fused 6-session bank; the box's float64
flux): DC's ms (CUDA events, four passes) and its kernels' ms
(torch.profiler, four passes) beside ``index_put_`` deterministic, the
bound and the redesign's floor, the largest bucket and tile, one JSON
line a regime. It calls only what the port had before DC's tiled
design (``det_commit``, ``DetWorkspace``, the walks, the service's
fusion), so a copy runs in an older checkout for an A/B.

It imports nothing of JAX; it needs one CUDA device and exits non-zero
without one.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

MESH_DIV = 20  # 20^3 cells -> 48,000 tets (bench.py MESH_DIV)
N = 500_000  # particles per batch (bench.py N)
CONTINUE_MOVES = 4
VMEM_BOUND = 1024  # bench.py run_vmem_blocked default bound
# Slots per CUDA block of the per-chunk grid the block walks' schedule
# replaced: each staged the table once its chunk held an active slot.
CHUNK_GRID_SLOTS = 256
CAPACITY_FACTOR = 2.0
CONSERVATION_RTOL = 1e-6
ORACLE_TOL = 1e-8
POS_ATOL = 1e-6
FLUX_RTOL = 1e-4
TIE_BAND = 1e-2  # two-tier vs float32 flux, L1 over total track length
BF16 = dict(walk_table_dtype="bfloat16")
K3_N = 500_000  # tools/exp_r3_vmem.py bench's default N
# W3's boxes (cells a side): the tool's sweep, L = 750, 1,296, 2,058 and
# 3,072 (neighbour ids in shared memory), and L = 3,360 (ids read from
# global memory).
W3_CELLS = ((5, 5, 5), (6, 6, 6), (7, 7, 7), (8, 8, 8), (8, 7, 10))
W3_REGIMES = {(8, 7, 10): "global adjacency"}  # else "shared adjacency"
# G1's gathered rows: the probes' T, and the main path's particle count.
G1_ROWS = (8192, 500_000)
# The 3x3 pincell assembly (BASELINE.json configs[0-1] geometry at
# assembly scale): FLAGSHIP_PINCELL cells, 60 layers -> 984,960 tets.
LATTICE, LATTICE_NZ = (3, 3), 60
# H100 SXM datasheet peaks: HBM bytes/s, f32 and f64 FLOP/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12
W0_F64_N = 100_000  # particles of the float64 W0 check on the box
# The partitioned facade's default configuration on the lattice (its
# brute-force point location is O(N*E)) and the forced-overflow run.
LATTICE_PART_N = 100_000
PART_OVERFLOW_N = 100_000
# The streaming cell (BASELINE.json configs[4]: 10M particles a batch,
# staged host -> device double-buffered), the JAX facade's default chunk.
STREAM_N = 10_000_000
STREAM_CHUNK = 1_000_000
STREAM_CONTINUE_MOVES = 2
STREAM_PART_CONTINUE_MOVES = 1  # the partitioned chunks are slower
# --staging-times: passes per arm, timed moves per pass.
STAGING_PASSES = 4
STAGING_MOVES = 4
# ~50 ms of SM cycles queued ahead of a call that must not wait for the
# device: it has to return while this still runs.
SLEEP_CYCLES = 100_000_000
# Operations per crossing in csrc/walk_step.cuh: per face two 3-term dot
# products (10), b (2), the crossing test (2), one division, the clamp
# and the running minimum (2); then the tally's subtract and multiply.
FLOPS_PER_CROSSING = 4 * 17 + 2
# The two-tier crossing (csrc/twotier_step.cuh): the select as above,
# then the winning face's refinement (16: the two dot products, b, the
# test, one division and the clamp); the lift is bit shifts.
FLOPS_PER_CROSSING_TWO_TIER = 4 * 17 + 16 + 2


def flat(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a.reshape(-1))


def sync():
    import torch

    torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` runs after one
    warm-up, with CUDA events."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def wall_ms(fn) -> float:
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return (time.perf_counter() - t0) * 1e3


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def check_equal(what: str, got, want) -> None:
    import torch

    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{what}: {bad} entries differ from the plain "
                             "version")


def check_flux(what: str, got, want) -> float:
    err = max_abs(got, want)
    scale = float(want.double().abs().max())
    if err > FLUX_RTOL * max(scale, 1e-30):
        raise AssertionError(f"{what}: flux differs by {err} (max {scale})")
    return err


def count_crossings(step, x, lelem, dest, active, base, tol,
                    seen=None) -> int:
    """Crossings this input needs: a lock-step replay of the walk that
    sums, per step, the particles still walking (block-local when
    ``base`` offsets stacked tables; a block exit ends the walk).
    ``step(rows, s, d0, dest, tol)`` is one crossing of every row: the
    plain versions' ``advance_cols`` on a packed table or
    ``advance_twotier`` on the two tiers. ``seen`` (bool, one a row):
    set where a particle crossed the row."""
    import torch

    d0 = dest - x
    s = torch.zeros_like(d0[:, 0])
    e = lelem.long()
    tol_t = torch.tensor(tol, dtype=x.dtype, device=x.device)
    total = 0
    while bool(active.any()):
        total += int(active.sum())
        if seen is not None:
            seen[(base + e)[active]] = True
        s_new, nxt, reached = step(base + e, s, d0, dest, tol_t)
        stop = reached | (nxt < 0)
        e = torch.where(active & ~stop, nxt.long(), e)
        s = torch.where(active, s_new, s)
        active = active & ~stop
    return total


def packed_step(table):
    from pumiumtally_tpu_torch.ops.walk import advance_cols

    return lambda rows, s, d0, dest, tol: advance_cols(table[rows], s, d0,
                                                       dest, tol)


def twotier_step(lo, hi):
    from functools import partial

    from pumiumtally_tpu_torch.ops.walk import advance_twotier

    return partial(advance_twotier, lo, hi)


def bound_entry(nbytes: float, crossings: int,
                flops_per_crossing: int = FLOPS_PER_CROSSING,
                flops: float = F32_FLOPS) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = crossings * flops_per_crossing / flops * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def sass_counts(name: str) -> dict:
    """For each kernel of the named library, from ``cuobjdump -sass``:
    its global loads (``LDG``; ``LDG.128`` the 16-byte ones among them),
    shared loads (``LDS``), and atomic and bulk-copy instructions by
    opcode. Empty where the toolkit has no cuobjdump."""
    from pumiumtally_tpu_torch import kernels

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(kernels._library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts = {}
    for fn, body in re.findall(r"Function : (\S+)\n(.*?)(?=Function : |\Z)",
                               sass, re.S):
        ops = re.findall(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)",
                         body)
        c = {"LDG": sum(op.startswith("LDG") for op in ops),
             "LDG.128": sum(bool(re.match(r"LDG\..*128", op))
                            for op in ops),
             "LDS": sum(op.startswith("LDS") for op in ops)}
        for op in ops:
            if op.startswith(("ATOM", "RED", "UBLKCP", "SYNCS")):
                c[op] = c.get(op, 0) + 1
        counts[fn] = c
    return counts


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def sm_clock() -> tuple:
    """The card's SM count and maximum SM clock in Hz (SM cycles per
    crossing are counted at that clock)."""
    import torch

    hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    return torch.cuda.get_device_properties(0).multi_processor_count, hz


def phase_device() -> tuple:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    print(f"# device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); nvidia-smi: {smi}")
    return name, smi


def phase_build() -> dict:
    """Builds every library; returns the builds it made, a library (0
    where a cached build matched)."""
    from pumiumtally_tpu_torch import kernels

    before = dict(kernels.build_counts)
    seconds = kernels.build()
    built = {n: kernels.build_counts[n] - before[n] for n in kernels.SOURCES}
    print(f"# build: {seconds:.2f} s for {sorted(kernels.SOURCES)}")
    for name in kernels.SOURCES:
        for line in kernels.build_log(name).splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                print(f"#   {name}: {line.strip()}")
    # W0's instances (float / double, packed table / two tiers, scoring
    # off / on): registers and spills, from ptxas's report.
    kernel, spills = None, "spills not reported"
    for line in kernels.build_log("walk").splitlines():
        m = re.search(
            r"properties for _Z\d+walk_kernelI(\w)Li(\d)ELb(\d)ELb(\d)E",
            line)
        if m:
            dtype = {"f": "float", "d": "double"}[m[1]]
            tier = WALK_LAYOUTS[int(m[2])]
            kernel = (f"walk_kernel<{dtype}> ({tier}"
                      f"{', scoring' if m[3] == '1' else ''}"
                      f"{', deterministic commit' if m[4] == '1' else ''})")
        elif kernel and "spill" in line:
            spills = line.strip()
        elif kernel and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)[1]
            print(f"# W0 {kernel}: {regs} registers; {spills}")
            kernel = None
    return built


def w0_inputs(mesh, pts, two_tier: bool = False, n: int = N) -> tuple:
    """The first move's walk inputs, localised by ``PumiTally``: the
    ``walk`` wrapper's positional arguments (``flux`` left out) and its
    keywords."""
    import torch

    from pumiumtally_tpu_torch import PumiTally, TallyConfig

    t = PumiTally(mesh, n, TallyConfig(check_found_all=False,
                                       **(BF16 if two_tier else {})))
    t.CopyInitialPosition(flat(pts[0][:n]))
    dev, dt = t.device, t.dtype
    assert t.mesh.two_tier == two_tier
    args = (t.mesh, t.x, t.elem,
            torch.as_tensor(pts[1][:n], dtype=dt, device=dev),
            torch.ones((n,), dtype=torch.int8, device=dev),
            torch.ones((n,), dtype=dt, device=dev))
    return args, dict(tally=True, tol=t._tol, max_iters=t._max_iters)


def w0_times(args, kw) -> dict:
    """W0's kernel time on these inputs, tallying (``ms``) and not
    (``untallied_ms``: no flux atomics; the main path's localisation and
    phase A), with CUDA events; the crossings the input needs and the SM
    cycles each costs at the card's maximum clock. It calls only the
    ``walk`` wrapper and the plain steps, as every checkout of the port
    has them."""
    import torch

    from pumiumtally_tpu_torch.ops.walk import walk

    m, x, elem, dest, fly, w = args
    zeros = lambda: torch.zeros((m.nelems,), dtype=x.dtype,  # noqa: E731
                                device=x.device)
    ms = cuda_ms(lambda: walk(*args, zeros(), **kw))
    untallied_ms = cuda_ms(lambda: walk(*args, None, **dict(kw, tally=False)))
    step = (twotier_step(m.walk_table_lo, m.walk_table_hi) if m.two_tier
            else packed_step(m.walk_table))
    crossings = count_crossings(step, x, elem, dest,
                                torch.ones_like(fly, dtype=torch.bool), 0,
                                kw["tol"])
    sms, hz = sm_clock()
    return {"ms": ms, "untallied_ms": untallied_ms, "crossings": crossings,
            "sm_cycles_per_crossing": ms * 1e-3 * sms * hz / crossings}


def phase_w0(mesh, pts, label: str = "", two_tier: bool = False,
             n: int = N) -> dict:
    """W0 (with ``two_tier``, its two-tier variant) vs walk_plain at the
    main path's shapes, in the mesh's dtype: ids, masks, iters, positions
    and s equal, flux at rtol 1e-4, and the kernel's count of walked
    particles equal to n. Prints crossings per second and SM cycles per
    crossing beside the kernel time, tallying and not."""
    import torch

    from pumiumtally_tpu_torch.ops.walk import walk, walk_plain

    name = "W0 two-tier" if two_tier else "W0"
    args, kw = w0_inputs(mesh, pts, two_tier, n)
    m, x = args[:2]

    def run(fn, **extra):
        flux = torch.zeros((m.nelems,), dtype=x.dtype, device=x.device)
        return fn(*args, flux, **kw, **extra)

    counts = torch.zeros((1,), dtype=torch.int32, device=x.device)
    rk, rp = run(walk, counts=counts), run(walk_plain)
    sync()
    for f in ("elem", "done", "exited", "iters", "x", "s"):
        check_equal(f"{name}{label} {f}", getattr(rk, f), getattr(rp, f))
    err_f = check_flux(f"{name}{label}", rk.flux, rp.flux)
    walked = int(counts[0])
    if walked != n:
        raise AssertionError(f"{name}{label}: the kernel walked {walked} "
                             f"particles, not {n}")
    times = w0_times(args, kw)
    ms, crossings = times["ms"], times["crossings"]
    plain_ms = wall_ms(lambda: run(walk_plain))
    k = x.element_size()
    # x, dest, elem, fly, w in; x, elem, done, exited, s out; each tet's
    # rows (the packed row, or the select row and four refinement rows)
    # and its flux read and written.
    row_bytes = 32 + 4 * 5 * k if two_tier else 20 * k
    nbytes = n * (11 * k + 11) + m.nelems * (row_bytes + 2 * k)
    bound = bound_entry(nbytes, crossings,
                        FLOPS_PER_CROSSING_TWO_TIER if two_tier
                        else FLOPS_PER_CROSSING,
                        F32_FLOPS if k == 4 else F64_FLOPS)
    sms, hz = sm_clock()
    print(f"# {name}{label}: {ms:.3f} ms kernel ({times['untallied_ms']:.3f}"
          f" ms untallied), {plain_ms:.3f} ms plain; {crossings} crossings, "
          f"{crossings / ms / 1e6:.3f} G crossings/s, "
          f"{times['sm_cycles_per_crossing']:.2f} SM cycles per crossing "
          f"({sms} SMs at {hz / 1e9:.3f} GHz max); walked {walked} of {n}; "
          f"x, s bitwise; flux max abs diff {err_f:.3e}; bound {bound}")
    return {"name": "W0 walk (two-tier)" if two_tier else "W0 walk",
            "route": "cuda",
            "source": "pumiumtally_tpu_torch/csrc/walk.cu",
            "replaces": ("pumiumtally_tpu/ops/walk.py:425" if two_tier
                         else "pumiumtally_tpu/ops/walk.py:449"),
            "max_abs_err": err_f, "ms": ms, "plain_ms": plain_ms, **bound,
            "library_ms": None}


def phase_block_walk(kind: str, mesh, pts, bound, shared: bool = True):
    """W1 (``kind`` "W1", float32 tables) or W2 ("W2", two-tier tables)
    against its plain version on every tallied round of the first move's
    phase, each round's input migrated from the kernel's previous output
    by the engine's own ``_migrate``: ids, masks, pending and iters
    equal, positions at 1e-6 (W1) or bitwise (W2), flux at rtol 1e-4;
    the kernel's slot counts equal to the round's active and idle slots.
    ``bound`` 1024 sub-splits the box (W1: 47 blocks, W2: 24 blocks whose
    bf16 rows may be staged in shared memory); W2 with None walks one
    block of the whole mesh from global memory (one round). Rounds 1 and
    2 are timed. Returns the kernel entry (round 1) and the CUDA blocks
    per regime summed over the rounds."""
    import torch

    from pumiumtally_tpu_torch import PartitionedPumiTally, TallyConfig
    from pumiumtally_tpu_torch.experiments.block_rounds import round_bytes
    from pumiumtally_tpu_torch.ops.pallas_walk import (
        pallas_walk_local,
        pallas_walk_local_plain,
        w2_uses_shared,
    )
    from pumiumtally_tpu_torch.ops.vmem_walk import (
        SCHED_COUNTS,
        vmem_walk_local,
        vmem_walk_local_plain,
    )

    w2 = kind == "W2"
    cfg = dict(walk_kernel="pallas", **BF16) if w2 else {}
    t = PartitionedPumiTally(
        mesh, N, TallyConfig(capacity_factor=CAPACITY_FACTOR,
                             walk_vmem_max_elems=bound,
                             check_found_all=False, **cfg),
    )
    t.CopyInitialPosition(flat(pts[0]))
    eng = t.engine
    L, dev = eng.part.L, t.device
    if w2 and w2_uses_shared(L, torch.float32) != shared:
        raise AssertionError(f"W2: blocks of {L} elements are not in the "
                             f"{'shared' if shared else 'global'} regime")
    if w2:
        tables = (eng.part.table, eng.part.table_hi)
        kernel, plain = pallas_walk_local, pallas_walk_local_plain
        step = twotier_step(*tables)
        flops = FLOPS_PER_CROSSING_TWO_TIER
        row_bytes = 32 + 4 * 20  # select row, four refinement rows
    else:
        tables = (eng.part.table,)
        kernel, plain = vmem_walk_local, vmem_walk_local_plain
        step = packed_step(eng.part.table)
        flops = FLOPS_PER_CROSSING
        row_bytes = 80
    staged_row = tables[0].shape[1] * tables[0].element_size()
    kw = dict(tally=True, tol=eng.tol, max_iters=eng.max_iters,
              blocks=eng.nparts)
    # The first move's tallied round 1 as the engine builds it.
    st = dict(eng.state)
    st["fly"] = st["alive"].to(torch.int8)
    st["w"] = st["fly"].to(torch.float32)
    st["done"] = ~st["alive"]
    st["exited"] = torch.zeros_like(st["done"])
    st["dest"] = eng._by_pid(torch.as_tensor(pts[1], dtype=torch.float32,
                                             device=dev), 0.0)

    def run(fn, st, **extra):
        flux = torch.zeros_like(eng.flux_padded)
        return fn(*tables, st["x"], st["lelem"], st["dest"], st["fly"],
                  st["w"], st["done"], st["exited"], flux, **kw, **extra)

    regimes = np.zeros(3, dtype=np.int64)
    staged, chunk_grid_staged, timed, err = [], [], [], 0.0
    S = st["x"].shape[0]
    base = (torch.arange(S, device=dev) // eng.cap_per_block) * L
    label = kind if not w2 else f"W2 ({'shared' if shared else 'global'})"
    for r in range(1, eng.max_rounds + 1):
        counts = torch.zeros(len(SCHED_COUNTS), dtype=torch.int32,
                             device=dev)
        rk = run(kernel, st, sched_counts=counts)
        rp = run(plain, st)
        sync()
        for i, f in ((1, "lelem"), (2, "done"), (3, "exited"),
                     (4, "pending"), (6, "iters")):
            check_equal(f"{label} round {r} {f}", rk[i], rp[i])
        if w2:
            check_equal(f"{label} round {r} x", rk[0], rp[0])
        elif max_abs(rk[0], rp[0]) > POS_ATOL:
            raise AssertionError(f"{label} round {r}: positions differ by "
                                 f"{max_abs(rk[0], rp[0])}")
        err = max(err, max_abs(rk[0], rp[0]),
                  check_flux(f"{label} round {r}", rk[5], rp[5]))
        c = counts.cpu().numpy()
        n_active = int((~st["done"]).sum())
        if (c[3], c[4]) != (n_active, S - n_active):
            raise AssertionError(
                f"{label} round {r}: the kernel walked {c[3]} slots and "
                f"wrote out {c[4]} idle ones; the round has {n_active} "
                f"active of {S}")
        regimes += c[:3]
        staged.append(int(c[2]) * L * staged_row)
        # What the per-chunk grid would stage on this round's masks.
        live = torch.nn.functional.pad(
            (~st["done"]).view(eng.nparts, eng.cap_per_block),
            (0, -eng.cap_per_block % CHUNK_GRID_SLOTS))
        chunks = live.view(eng.nparts, -1, CHUNK_GRID_SLOTS).any(dim=2)
        chunk_grid_staged.append(int(chunks.sum()) * L * staged_row)
        n_paused = int((rk[4] >= 0).sum())
        if r <= 2:
            x0 = st["x"]
            dest_c = x0 + (st["dest"] - x0) if w2 else st["dest"]
            crossings = count_crossings(step, x0, st["lelem"], dest_c,
                                        ~st["done"], base, eng.tol)
            nbytes = round_bytes(st["done"], st["exited"], eng.nparts, L,
                                 row_bytes, 4)
            bound_r = bound_entry(nbytes, crossings, flops)
            ev_ms = cuda_ms(lambda: run(kernel, st))
            dev_ms = device_us(lambda: run(kernel, st), 5,
                               "block_walk_kernel") / 1e3
            plain_ms = wall_ms(lambda: run(plain, st))
            # The profiler's device time: a later round's kernel takes less
            # time on the card than its wrapper on the host, so events
            # around back-to-back calls (printed beside) time the host.
            timed.append(dict(ms=dev_ms, plain_ms=plain_ms, **bound_r))
            print(f"# {label} round {r}: {eng.nparts} blocks of <= {L} "
                  f"elements, {eng.cap_per_block} slots each, {n_active} "
                  f"active; {ev_ms:.4f} ms kernel (events), {dev_ms:.4f} "
                  f"ms (profiler), {plain_ms:.3f} ms plain; {crossings} "
                  f"crossings, {n_paused} paused; counts "
                  f"{dict(zip(SCHED_COUNTS, c.tolist()))}, {staged[-1]} B "
                  f"staged (a per-chunk grid: {chunk_grid_staged[-1]} B); "
                  f"{nbytes} B to move, bound {bound_r}")
        if n_paused == 0:
            break
        st = eng._migrate(dict(st, x=rk[0], lelem=rk[1], done=rk[2],
                               exited=rk[3], pending=rk[4]))
    if (r > 1) != (eng.nparts > 1):
        raise AssertionError(f"{label}: {r} rounds over {eng.nparts} blocks")
    print(f"# {label}: {r} rounds, each equal to the plain version and "
          f"walking every active slot once; CUDA blocks per regime over "
          f"them {dict(zip(SCHED_COUNTS, regimes.tolist()))}; staged bytes "
          f"per round {staged} (a per-chunk grid: {chunk_grid_staged})")
    name, src, line = (
        ("W2 twotier_block_walk", "twotier_block_walk.cu",
         "pumiumtally_tpu/ops/pallas_walk.py:175") if w2 else
        ("W1 block_walk", "block_walk.cu",
         "pumiumtally_tpu/ops/vmem_walk.py:250"))
    return {"name": name, "route": "cuda",
            "source": f"pumiumtally_tpu_torch/csrc/{src}", "replaces": line,
            "max_abs_err": err, **timed[0], "library_ms": None}, regimes


# W4's cells (phase 4b): (label, engine knobs, scoring, float64). The
# box as one block (the partitioned facades' default configuration), the
# same on the two-tier tables (``walk_table_dtype="bfloat16"`` as it
# ships), the gather sub-split into blocks of <= VMEM_BOUND elements
# (47), the same with the int32 sidecar, the bf16 reroute (24 blocks),
# float32 scoring on one block and on the sub-split, the bf16 reroute
# with scoring, and float64 on one block. The lattice as one block
# (LATTICE_PART_N particles) runs with the lattice's phases.
W4_SUBSPLIT = dict(vmem_walk_max_elems=VMEM_BOUND, block_kernel="gather")
W4_BF16 = dict(vmem_walk_max_elems=VMEM_BOUND, block_kernel="vmem",
               table_dtype="bfloat16")
W4_CELLS = (
    ("box", {}, False, False),
    ("box, two-tier", dict(table_dtype="bfloat16"), False, False),
    ("sub-split", W4_SUBSPLIT, False, False),
    ("sidecar", dict(W4_SUBSPLIT, sidecar=True), False, False),
    ("bf16 reroute", W4_BF16, False, False),
    ("box, scoring", {}, True, False),
    ("sub-split, scoring", W4_SUBSPLIT, True, False),
    ("bf16 reroute, scoring", W4_BF16, True, False),
    ("box, float64", {}, False, True),
)
W4_PASSES = 4
# W4 on more listed blocks than grid.y's 65,535: the box's sub-split into
# blocks of <= W4_MANY_BOUND elements (750 of them), W4_MANY_N particles,
# its round-1 input stacked W4_MANY_REPS times (70,500 blocks).
W4_MANY_BOUND, W4_MANY_N, W4_MANY_REPS = 64, 30_000, 94
W4_ENTRIES = {  # kernel entry -> the cell whose round 1 its line reports
    "gather_block_walk": "box",
    "gather_block_walk_twotier": "bf16 reroute",
    "gather_block_walk_scored": "box, scoring",
    "gather_block_walk_twotier_scored": "bf16 reroute, scoring",
}


def w4_engine(mesh, pts, n: int, sidecar: bool = False, spec=None,
              **knobs) -> tuple:
    """A ``PartitionedEngine`` with these knobs (``sidecar``: a partition
    with the forced int32 adjacency sidecar, as many blocks as the knobs
    give) localised to ``pts[0]``, and the first move's round-1 slot
    state (every particle flying with weight 1 toward ``pts[1]``, with
    ``sbin``/``sfac`` rows from ``score_lanes`` under ``spec``)."""
    import torch

    from pumiumtally_tpu_torch import TallyConfig
    from pumiumtally_tpu_torch.parallel.partition import (
        PartitionedEngine,
        build_partition,
        engine_partition,
    )
    from pumiumtally_tpu_torch.scoring import ScoringRuntime

    # On the card, as the facades place their meshes.
    mesh = mesh.to(dtype=mesh.dtype, device=torch.device(
        "cuda" if torch.cuda.is_available() else "cpu"))
    dt, dev = mesh.dtype, mesh.device
    # One block: the default configuration's capacity factor, as it
    # ships; a sub-split's blocks hold uneven shares of the particles
    # and keep CAPACITY_FACTOR, as W1's and W2's phases do.
    cf = (CAPACITY_FACTOR if knobs.get("vmem_walk_max_elems")
          else TallyConfig().capacity_factor)
    kw = dict(capacity_factor=cf, tol=1e-8 if dt ==
              torch.float64 else 1e-6, max_iters=64 + mesh.nelems,
              check_found_all=False, scoring=spec, **knobs)
    if sidecar:
        nparts = engine_partition(mesh, knobs["vmem_walk_max_elems"],
                                  "gather", "float32").ndev
        kw["part"] = build_partition(mesh, nparts, force_split_adj=True)
    eng = PartitionedEngine(mesh, n, **kw)
    if sidecar and eng.part.adj_int is None:
        raise AssertionError("W4 sidecar: the partition has no sidecar")
    eng.localize(torch.as_tensor(pts[0][:n], dtype=dt, device=dev))
    st = dict(eng.state)
    st["fly"] = st["alive"].to(torch.int8)
    st["w"] = st["fly"].to(dt)
    st["done"] = ~st["alive"]
    st["exited"] = torch.zeros_like(st["done"])
    st["dest"] = eng._by_pid(torch.as_tensor(pts[1][:n], dtype=dt,
                                             device=dev), 0.0)
    rt = None
    if spec is not None:
        rt = ScoringRuntime(spec, mesh.nelems, dt, dev,
                            bank_size=eng.score_padded.numel())
        sbin_n, sfac_n, _ = score_lanes(rt, n, 6)
        st["sbin"] = eng._by_pid(sbin_n, 0)
        st["sfac"] = eng._by_pid(sfac_n, 0.0)
    return eng, rt, st


def w4_work(eng, st, ids) -> tuple:
    """(crossings, distinct rows crossed) of one W4 round on this input:
    a lock-step replay of the walks of the listed blocks' active slots
    (the plain exit steps), each ending at its destination, the
    boundary or a block face."""
    import torch

    from pumiumtally_tpu_torch.ops.walk import refine_face_hi, select_faces_lo
    from pumiumtally_tpu_torch.parallel.partition import exit_cols_x0

    part, cb = eng.part, eng.cap_per_block
    slot_block = torch.arange(eng.cap, device=st["x"].device) // cb
    walked = torch.ones(eng.nparts, dtype=torch.bool, device=slot_block.device)
    if ids is not None:
        walked[:] = False
        walked[ids.long()] = True
    active = ~st["done"] & walked[slot_block]
    x0 = st["x"]
    d0 = st["dest"] - x0
    dest_c = x0 + d0
    s = torch.zeros_like(d0[:, 0])
    e = slot_block * part.L + st["lelem"].long()
    tol = torch.tensor(eng.tol, dtype=x0.dtype, device=x0.device)
    crossings, seen = 0, []
    idx = active.nonzero().squeeze(1)
    while idx.numel():
        rows = e[idx]
        seen.append(rows)
        crossings += int(idx.numel())
        if eng.two_tier:
            s_sel, f = select_faces_lo(part.table, s[idx], rows, dest_c[idx],
                                       d0[idx], tol)
            s_exit, nxt = refine_face_hi(part.table_hi, s[idx], rows, f,
                                         s_sel, dest_c[idx], d0[idx], tol)
        else:
            s_exit, nxt = exit_cols_x0(
                part.table[rows], s[idx], x0[idx], d0[idx], tol,
                None if part.adj_int is None else part.adj_int[rows])
        stop = (s_exit >= 1) | (nxt < 0)
        e[idx] = torch.where(stop, e[idx],
                             slot_block[idx] * part.L + nxt.long())
        s[idx] = torch.clamp(s_exit, max=1.0)
        idx = idx[~stop]
    rows = torch.unique(torch.cat(seen)).numel() if seen else 0
    return crossings, rows


def w4_bytes(eng, st, ids, rows: int, spec=None, bank=None) -> int:
    """Bytes a W4 round must move on this input: each slot of the front
    (the not-done slots of the walked blocks) reads x, lelem, dest, fly,
    w and its masks and writes x, lelem, its masks and pending once (57
    B in f32); every other slot's ``done`` flag is read once (1 B), to
    find the front; each crossed row (80 B packed in f32, with the
    sidecar 96 B; two-tier a 32 B select row and its four 20 B
    refinement rows) and its flux entry are read and written once; with
    scoring each bank lane touched is read and written once and each
    front slot's bin offset and factors read once. The work list (4 B an
    entry, written and read) is the design's, not the round's, and the
    wrapper's ``pending`` fill is outside W4's kernels: neither is
    charged."""
    import torch

    k = st["x"].element_size()
    front = ~st["done"]
    if ids is not None:
        walked = torch.zeros((eng.nparts,), dtype=torch.bool,
                             device=ids.device)
        walked[ids.long()] = True
        front = (front.view(eng.nparts, -1) & walked[:, None]).view(-1)
    n_front = int(front.sum())
    row_bytes = (32 + 4 * 5 * k if eng.two_tier
                 else 20 * k + (16 if eng.part.adj_int is not None else 0))
    nbytes = (n_front * (10 * k + 17) + (front.numel() - n_front)
              + rows * (row_bytes + 2 * k))
    if spec is not None:
        nbytes += bank_bytes(bank, k) + n_front * (4 + spec.n_scores * k)
    return nbytes


# W4's device activity: the walk and the kernels that build a later
# round's work list (``work_list``).
W4_KERNELS = ("gather_block_walk_kernel", "work_count_kernel",
              "work_scan_kernel", "work_write_kernel")


def w4_profile(fn, launches: int = 1, reps: int = 5) -> tuple:
    """Device ms a call of ``fn`` (``launches`` W4 walks a call):
    (W4's kernels, W4_KERNELS, summed; every device activity of the
    call; the walk kernel alone) over ``reps`` calls under
    torch.profiler. A window whose count of walks is not ``reps *
    launches`` is profiled again, twice at most; then CUDA events time
    the calls queued behind a sleep kernel (every activity of the call,
    for all three)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync()
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        walks = sum("gather_block_walk_kernel" in e.name for e in ev)
        if walks == reps * launches:
            w4 = sum(e.time_range.elapsed_us() for e in ev
                     if any(k in e.name for k in W4_KERNELS))
            every = sum(e.time_range.elapsed_us() for e in ev)
            walk = sum(e.time_range.elapsed_us() for e in ev
                       if "gather_block_walk_kernel" in e.name)
            return w4 / reps / 1e3, every / reps / 1e3, walk / reps / 1e3
        print(f"# profiler retry: {walks} of {reps * launches} W4 walks in "
              "a window; profiling again")
    ms = queued_ms(fn, reps)
    print(f"# profiler retry: W4 timed with events behind a sleep kernel "
          f"instead: {ms:.4f} ms")
    return ms, ms, ms


def w4_ms(fn) -> list:
    """W4_PASSES device times of ``fn`` in ms: W4's kernels
    (``w4_profile``), the list build included."""
    return [w4_profile(fn)[0] for _ in range(W4_PASSES)]


def w4_move_ms(fns: list, launches: int) -> float:
    """The device ms of one move's W4 rounds: every round's call in turn
    (``fns``, into its standing buffers), W4's kernels summed over the
    move (``w4_profile``, one move a window)."""
    def move():
        for f in fns:
            f()

    return w4_profile(move, launches, reps=1)[0]


W4_KEYS = ("x", "lelem", "dest", "fly", "w", "done", "exited")


def w4_call(eng, st, first: bool, flux, sc, tally: bool = True,
            counts=None):
    """A call that runs W4 on the round input ``st`` as the engine's
    round does, adding into ``flux`` (and the bank in ``sc``): in a
    checkout with ``walk_local_list``, in place on copies of the walked
    rows that each call first restores from ``st``, without a list in
    the phase's ``first`` round, else over ``work_list`` of ``done`` (a
    full migrate's list), with ``counts``; in an older checkout,
    ``walk_local`` over the occupied blocks."""
    import torch

    from pumiumtally_tpu_torch.parallel import partition

    kw = dict(tally=tally, tol=eng.tol, max_iters=eng.max_iters,
              blocks=eng.nparts, adj_int=eng.part.adj_int,
              table_hi=eng.part.table_hi, scoring=sc)
    if not hasattr(partition, "walk_local_list"):
        ids = None
        if eng.nparts > 1:
            ids = (~st["done"]).view(eng.nparts, -1).any(dim=1)
            ids = ids.nonzero().squeeze(1).to(torch.int32)
        return functools.partial(partition.walk_local, eng.part.table,
                                 *(st[k] for k in W4_KEYS), flux,
                                 block_ids=ids, **kw)
    rows = {k: st[k].clone() for k in partition.WALKED_ROWS}

    def call():
        for k, v in rows.items():
            v.copy_(st[k])
        work = None if first else partition.work_list(rows["done"])
        return partition.walk_local_list(
            eng.part.table, *(rows.get(k, st[k]) for k in W4_KEYS), flux,
            work, counts=counts, **kw)

    return call


def phase_w4(mesh, pts, mesh64, label: str, knobs: dict, scoring: bool,
             f64: bool, n: int = 0) -> dict:
    """W4 (csrc/gather_block_walk.cu) against ``walk_local_blocks_plain``
    on the card, on every tallied round of the first move (each round's
    input migrated by the engine's ``_migrate`` from the kernel's
    output; the occupied-block list carried as the engine carries it):
    ids, masks, pending and iters equal, positions bitwise, flux at rtol
    1e-4 of its largest element, scoring lanes as phase 6b holds them;
    the blocks the kernel walks must be those whose slots hold a
    not-done particle, one launch a round. Each round also runs the
    engine's call (``w4_call``): round 1 without a list, later rounds
    over the list W4 builds from ``done`` (equal to ``work_list_plain``),
    in place on copies: equal to the plain version, and the kernel's
    count of the slots it walked equal to the list's length. Those
    calls are timed: rounds 1 and 2, W4_PASSES passes into standing
    buffers (one-block cells also untallied), beside each round's bound
    and the plain version's wall time; the whole move's rounds,
    W4_PASSES passes, beside the bound summed over them. ``n``: the
    particles (0: N, or W0_F64_N in float64). Returns the cell's round-1
    entry."""
    import torch

    from pumiumtally_tpu_torch import kernels
    from pumiumtally_tpu_torch.parallel.partition import (
        _occupancy_counts,
        walk_local,
        walk_local_blocks_plain,
        work_list,
        work_list_plain,
    )

    m = mesh64 if f64 else mesh
    n = n or (W0_F64_N if f64 else N)
    spec = score_spec() if scoring else None
    eng, rt, st = w4_engine(m, pts, n, spec=spec, **knobs)
    if eng.use_vmem_walk or eng.use_pallas_walk:
        raise AssertionError(f"W4 {label}: the engine does not run W4")
    entry = ("gather_block_walk" + ("_twotier" if eng.two_tier else "")
             + ("_scored" if scoring else ""))
    k = st["x"].element_size()
    kw = dict(tally=True, tol=eng.tol, max_iters=eng.max_iters,
              blocks=eng.nparts, adj_int=eng.part.adj_int,
              table_hi=eng.part.table_hi)
    keys = W4_KEYS

    def buffers():
        return (torch.zeros_like(eng.flux_padded),
                None if spec is None else torch.zeros_like(eng.score_padded))

    def run(fn, st, ids, tally=True, bufs=None):
        flux, bank = bufs or buffers()
        sc = None
        if spec is not None and tally:
            sc = (spec.kinds, bank, st["sbin"], st["sfac"])
        return fn(eng.part.table, *(st[k_] for k_ in keys),
                  flux if tally else None, **dict(kw, tally=tally),
                  scoring=sc, block_ids=ids), bank

    n_act = _occupancy_counts(st["done"], eng.nparts)
    err, rounds, move_bound, timed, fns = 0.0, [], 0.0, [], []
    flops = (FLOPS_PER_CROSSING_TWO_TIER if eng.two_tier
             else FLOPS_PER_CROSSING) + (3 if scoring else 0)
    for r in range(1, eng.max_rounds + 1):
        occupied = int((~st["done"]).view(eng.nparts, -1).any(dim=1).sum())
        ids = None
        if eng.nparts > 1:
            ids = (n_act > 0).nonzero().squeeze(1).to(torch.int32)
            if int(ids.numel()) != occupied:
                raise AssertionError(
                    f"W4 {label} round {r}: {int(ids.numel())} blocks "
                    f"dispatched, {occupied} hold a not-done slot")
        before = kernels.launch_counts[entry]
        rk, bank_k = run(walk_local, st, ids)
        sync()
        t0 = time.perf_counter()
        rp, bank_p = run(walk_local_blocks_plain, st, ids)
        sync()
        plain_ms = (time.perf_counter() - t0) * 1e3
        launched = kernels.launch_counts[entry] - before
        if launched != int(occupied > 0):
            raise AssertionError(f"W4 {label} round {r}: {launched} launches "
                                 f"of {entry} for {occupied} blocks")
        for i, f in ((0, "x"), (1, "lelem"), (2, "done"), (3, "exited"),
                     (4, "pending"), (6, "iters")):
            check_equal(f"W4 {label} round {r} {f}", rk[i], rp[i])
        err = max(err, check_flux(f"W4 {label} round {r}", rk[5], rp[5]))
        if spec is not None:
            err = max(err, check_bank(f"W4 {label} round {r}", bank_k,
                                      bank_p, spec.kinds))
        # The engine's call: round 1 without a list, later rounds over
        # the list W4 builds from done.
        if r > 1:
            got, want = work_list(st["done"]), work_list_plain(st["done"])
            listed = int(want[1])
            if int(got[1]) != listed or not torch.equal(
                    got[0][:listed], want[0][:listed]):
                raise AssertionError(f"W4 {label} round {r}: the list "
                                     "build differs from work_list_plain")
        listed = int((~st["done"]).sum())
        flux_l, bank_l = buffers()
        walked_n = torch.zeros((1,), dtype=torch.int32,
                               device=st["x"].device)
        sc_l = None if spec is None else (spec.kinds, bank_l, st["sbin"],
                                          st["sfac"])
        rl = w4_call(eng, st, r == 1, flux_l, sc_l, counts=walked_n)()
        if int(walked_n) != listed:
            raise AssertionError(f"W4 {label} round {r}: the kernel walked "
                                 f"{int(walked_n)} slots, the round's list "
                                 f"holds {listed}")
        for i, f in ((0, "x"), (1, "lelem"), (2, "done"), (3, "exited"),
                     (4, "pending"), (6, "iters")):
            check_equal(f"W4 {label} round {r} engine call {f}", rl[i],
                        rp[i])
        err = max(err, check_flux(f"W4 {label} round {r} engine call",
                                  flux_l, rp[5]))
        if spec is not None:
            err = max(err, check_bank(f"W4 {label} round {r} engine call",
                                      bank_l, bank_p, spec.kinds))
        n_paused = int((rk[4] >= 0).sum())
        crossings, rows = w4_work(eng, st, ids)
        nbytes = w4_bytes(eng, st, ids, rows, spec, bank_p)
        bound = bound_entry(nbytes, crossings, flops,
                            F32_FLOPS if k == 4 else F64_FLOPS)
        move_bound += bound["bound_ms"]
        # This round's engine call, adding into standing flux and bank
        # buffers, for the move's time.
        flux_t, bank_t = buffers()
        fns.append(w4_call(eng, st, r == 1, flux_t, None if spec is None
                           else (spec.kinds, bank_t, st["sbin"],
                                 st["sfac"])))
        if r <= 2:
            t_on = w4_ms(fns[-1])
            t_off = (w4_ms(w4_call(eng, st, r == 1, None, None, False))
                     if eng.nparts == 1 and spec is None else [])
            timed.append(dict(ms=float(np.median(t_on)), plain_ms=plain_ms,
                              **bound))
            print(f"# W4 {label} round {r}: {eng.nparts} blocks of <= "
                  f"{eng.part.L}, {eng.cap_per_block} slots each, "
                  f"{int((~st['done']).sum())} active in {occupied} "
                  f"blocks; kernel {', '.join(f'{v:.4f}' for v in t_on)} ms"
                  + (f", untallied {', '.join(f'{v:.4f}' for v in t_off)} "
                     "ms" if t_off else "")
                  + f" (profiler, {W4_PASSES} passes, the list build "
                  f"included); plain {plain_ms:.3f} ms; {listed} listed "
                  f"slots walked; {crossings} crossings over {rows} rows, "
                  f"{n_paused} paused; {nbytes} B; bound {bound}")
        rounds.append(occupied)
        if n_paused == 0:
            break
        # The engine's occupancy rule: walked blocks recount, then the
        # full migrate recounts every block.
        st = eng._migrate(dict(st, x=rk[0], lelem=rk[1], done=rk[2],
                               exited=rk[3], pending=rk[4]))
        n_act = _occupancy_counts(st["done"], eng.nparts)
    if (len(rounds) > 1) != (eng.nparts > 1):
        raise AssertionError(f"W4 {label}: {len(rounds)} rounds over "
                             f"{eng.nparts} blocks")
    move = [w4_move_ms(fns, len(fns)) for _ in range(W4_PASSES)]
    print(f"# W4 {label}: {len(rounds)} rounds ({entry}), each equal to the "
          f"plain version; occupied blocks a round {rounds} "
          f"({sum(rounds)} dispatched of {len(rounds) * eng.nparts}); the "
          f"first move's rounds {', '.join(f'{v:.4f}' for v in move)} ms "
          f"(profiler, {W4_PASSES} passes), bound {move_bound:.4f} ms; max "
          f"abs err {err:.3e}")
    return {"name": f"W4 {entry}", "route": "cuda", "entry": entry,
            "source": "pumiumtally_tpu_torch/csrc/gather_block_walk.cu",
            "replaces": "pumiumtally_tpu/parallel/partition.py:466",
            "max_abs_err": err, **timed[0], "library_ms": None}


def phase_w4_list(mesh, pts) -> dict:
    """W4's list build ``work_list`` (a round after a full migrate)
    against ``work_list_plain`` on the card, on the 47-block sub-split's
    round-2 input (round 1 walked, then the engine's ``_migrate``): the
    same list and length. Its device time (every activity of its call,
    W4_PASSES passes), the plain version's wall time, the bound (each
    ``done`` flag read, the list written: n + 4 B a listed slot) and
    ``torch.argsort`` of ``done`` (stable: the same list). Returns its
    ``kernels`` entry."""
    import torch

    from pumiumtally_tpu_torch.parallel.partition import (
        walk_local,
        work_list,
        work_list_plain,
    )

    sub, _, st = w4_engine(mesh, pts, N, **W4_SUBSPLIT)
    ids = torch.arange(sub.nparts, dtype=torch.int32, device=st["x"].device)
    res = walk_local(sub.part.table, *(st[k] for k in W4_KEYS),
                     torch.zeros_like(sub.flux_padded), tally=True,
                     tol=sub.tol, max_iters=sub.max_iters, blocks=sub.nparts,
                     block_ids=ids)
    st = sub._migrate(dict(st, x=res[0], lelem=res[1], done=res[2],
                           exited=res[3], pending=res[4]))
    done = st["done"]
    got, want = work_list(done), work_list_plain(done)
    listed = int(want[1])
    if int(got[1]) != listed or not torch.equal(got[0][:listed],
                                                want[0][:listed]):
        raise AssertionError("W4 work list: differs from work_list_plain")
    ms = [device_us(lambda: work_list(done), reps=5) / 1e3
          for _ in range(W4_PASSES)]
    plain_ms = wall_ms(lambda: work_list_plain(done))
    lib_ms = device_us(lambda: torch.argsort(done, stable=True),
                       reps=5) / 1e3
    nbytes = done.numel() + 4 * listed
    bound = bound_entry(nbytes, 0)
    print(f"# W4 work list (gather_work_list): {listed} listed of "
          f"{done.numel()} slots, equal to the plain version; "
          f"{', '.join(f'{v:.4f}' for v in ms)} ms (profiler, {W4_PASSES} "
          f"passes); plain {plain_ms:.3f} ms; library {lib_ms} ms; "
          f"{nbytes} B; bound {bound}")
    return {"name": "W4 work list", "route": "cuda",
            "entry": "gather_work_list",
            "source": "pumiumtally_tpu_torch/csrc/gather_block_walk.cu",
            "replaces": "pumiumtally_tpu/parallel/partition.py:466",
            "max_abs_err": 0.0, "ms": float(np.median(ms)),
            "plain_ms": plain_ms, **bound, "library_ms": lib_ms}


def phase_w4_many_blocks(mesh, pts, reps: int = W4_MANY_REPS,
                         n: int = W4_MANY_N) -> None:
    """W4 on an occupied-block list longer than a grid's y dimension
    allows (65,535): the box's gather sub-split into blocks of <=
    W4_MANY_BOUND elements (750), its round-1 input stacked ``reps``
    times (70,500 blocks, every one occupied), every 16th left off the
    list (66,094 listed), against ``walk_local_blocks_plain`` as
    phase_w4 holds it, in one launch."""
    import torch

    from pumiumtally_tpu_torch import kernels
    from pumiumtally_tpu_torch.parallel.partition import (
        walk_local,
        walk_local_blocks_plain,
    )

    eng, _, st = w4_engine(mesh, pts, n, vmem_walk_max_elems=W4_MANY_BOUND,
                           block_kernel="gather")
    blocks = eng.nparts * reps
    keys = ("x", "lelem", "dest", "fly", "w", "done", "exited")
    slots = [st[k].repeat((reps,) + (1,) * (st[k].dim() - 1)) for k in keys]
    table = eng.part.table.repeat(reps, 1)
    # The occupied blocks, less every 16th: a listed block must be the
    # one walked, and an unlisted one kept.
    busy = (~slots[5]).view(blocks, -1).any(dim=1)
    busy[15::16] = False
    ids = busy.nonzero().squeeze(1).to(torch.int32)
    if ids.numel() <= 65_535:
        raise AssertionError(f"W4 many blocks: {ids.numel()} listed blocks, "
                             "not past 65,535")
    kw = dict(tally=True, tol=eng.tol, max_iters=eng.max_iters,
              blocks=blocks, block_ids=ids)
    before = kernels.launch_counts["gather_block_walk"]
    rk = walk_local(table, *slots, torch.zeros((blocks * eng.part.L,),
                    dtype=table.dtype, device=table.device), **kw)
    rp = walk_local_blocks_plain(table, *slots, torch.zeros_like(rk[5]),
                                 **kw)
    sync()
    launched = kernels.launch_counts["gather_block_walk"] - before
    if launched != int(table.is_cuda):
        raise AssertionError(f"W4 many blocks: {launched} launches")
    for i, f in ((0, "x"), (1, "lelem"), (2, "done"), (3, "exited"),
                 (4, "pending"), (6, "iters")):
        check_equal(f"W4 many blocks {f}", rk[i], rp[i])
    err = check_flux("W4 many blocks", rk[5], rp[5])
    print(f"# W4 many blocks: {int(ids.numel())} listed of {blocks} blocks "
          f"of <= {eng.part.L} ({eng.nparts} blocks stacked {reps} times, "
          f"{eng.cap_per_block} slots each), one launch, equal to the plain "
          f"version; max abs err {err:.3e}")


def w3_setup(dims: tuple):
    """The tool's W3 inputs (``r3_vmem.setup``: K3_N particles localized
    in a float32 unit box, destinations one normal step away) on a box
    of nx x ny x nz cells. ``setup`` builds cubes; a box of other sides
    goes through the same recipe with its ``build_box`` call widened."""
    from unittest import mock

    from pumiumtally_tpu_torch.experiments import r3_vmem

    if len(set(dims)) == 1:
        inputs = r3_vmem.setup(dims[0], K3_N, seed=0)
    else:
        box = r3_vmem.build_box
        with mock.patch.object(r3_vmem, "build_box",
                               lambda *a, **kw: box(1, 1, 1, *dims, **kw)):
            inputs = r3_vmem.setup(dims[0], K3_N, seed=0)
    L = inputs[0].nelems
    if L != 6 * math.prod(dims):
        raise AssertionError(f"W3 inputs: a box of {dims} cells gave {L} "
                             f"tets, not {6 * math.prod(dims)}")
    return inputs


def w3_regime(L: int) -> str:
    """W3's regime at L in this checkout: where its neighbour ids live
    (a checkout without the shared-adjacency regime reads them from
    global memory at every L)."""
    from pumiumtally_tpu_torch.experiments import r3_vmem

    shared = getattr(r3_vmem, "w3_shared_adj", lambda L: False)(L)
    return "shared adjacency" if shared else "global adjacency"


def w3_times(inputs, passes: int) -> dict:
    """W3's kernel time on one cell over ``passes`` profiled passes of 5
    calls, W0's on the same input, the crossings the input needs and the
    SM cycles each costs at the card's maximum clock, the bytes bound,
    and, where this checkout's ``walk_vmem`` takes ``counts``, the
    particles walked, the warp steps and the lanes' busy share
    (crossings / (32 x warp steps)). ``entry_ms`` is the entry point's
    own time per call (CUDA events around 10 back-to-back calls of
    ``walk_vmem``, as ``r3_vmem.bench`` times it): the kernel plus what
    the wrapper does around it. It calls only ``walk_vmem`` and ``walk``,
    as every checkout of the port has them."""
    import inspect

    import torch

    from pumiumtally_tpu_torch.experiments import r3_vmem
    from pumiumtally_tpu_torch.ops.walk import walk

    mesh, x, elem, dest = inputs
    L, n, dev = mesh.nelems, x.shape[0], x.device
    fly = torch.ones((n,), dtype=torch.int8, device=dev)
    w = torch.ones((n,), dtype=torch.float32, device=dev)
    kw = dict(tol=r3_vmem.TOL, max_iters=r3_vmem.MAX_ITERS)

    def run(fn, **extra):
        flux = torch.zeros((L,), dtype=torch.float32, device=dev)
        return fn(mesh, x, elem, dest, fly, w, flux, **kw, **extra)

    ms = [device_us(lambda: run(r3_vmem.walk_vmem), 5, "resident_walk") / 1e3
          for _ in range(passes)]
    entry_ms = cuda_ms(lambda: run(r3_vmem.walk_vmem), 10)
    w0_ms = device_us(lambda: run(lambda *a, **k: walk(*a, tally=True, **k)),
                      5, "walk_kernel<") / 1e3
    crossings = count_crossings(packed_step(mesh.walk_table), x, elem, dest,
                                torch.ones_like(fly, dtype=torch.bool), 0,
                                r3_vmem.TOL)
    sms, hz = sm_clock()
    # Per particle as W0 (x, dest, elem, fly, w in; x, elem, done,
    # exited, s out); per element the plane row, the ids, flux in and out.
    nbytes = n * (12 + 12 + 4 + 1 + 4 + 12 + 4 + 1 + 1 + 4) + L * (64 + 16
                                                                    + 8)
    out = {"L": L, "regime": w3_regime(L), "n": n, "ms": ms,
           "entry_ms": entry_ms, "w0_ms": w0_ms,
           "crossings": crossings,
           "sm_cycles_per_crossing": [t * 1e-3 * sms * hz / crossings
                                      for t in ms],
           "walked": None, "warp_steps": None, "busy_share": None,
           **bound_entry(nbytes, crossings)}
    if "counts" in inspect.signature(r3_vmem.walk_vmem).parameters:
        counts = torch.zeros((2,), dtype=torch.int32, device=dev)
        run(r3_vmem.walk_vmem, counts=counts)
        walked, steps = (int(c) for c in counts.tolist())
        out.update(walked=walked, warp_steps=steps,
                   busy_share=crossings / (32 * steps) if steps else None)
    return out


def phase_w3() -> dict:
    """W3 (csrc/resident_walk.cu) through its experiment entry point
    ``r3_vmem.bench`` (the tool's L sweep with W3 and W0), launches
    counted over that run; then, at each W3_CELLS box, W3 against
    ``walk_vmem_plain`` on the tool's inputs (ids, masks, x and s equal,
    flux at rtol 1e-4, walked == n), its time, busy share and SM cycles
    per crossing, and W0's time on the same input."""
    import torch

    from pumiumtally_tpu_torch import kernels
    from pumiumtally_tpu_torch.experiments import r3_vmem

    kernels.reset_launch_counts()
    r3_vmem.bench(K3_N)
    launches = kernels.launch_counts["resident_walk"]
    if launches == 0:
        raise AssertionError("W3: r3_vmem.bench never launched it")
    sass = sass_counts("resident_walk")
    print(f"# W3 SASS: {sass}")
    if not sass:
        raise AssertionError("W3: no cuobjdump in the CUDA toolkit; the "
                             "global loads of its instances go unchecked")
    # The two regimes' instances (template kSharedAdj true: ILb1E, false:
    # ILb0E) differ by the global read of a neighbour id: the
    # shared-adjacency one reads no mesh data from global memory (its
    # loads are the staging copy's and a refilled particle's inputs).
    ldg = {fn: c["LDG"] for fn, c in sass.items()}
    shared = [n for fn, n in ldg.items() if "ILb1E" in fn]
    glob = [n for fn, n in ldg.items() if "ILb0E" in fn]
    if len(shared) != 1 or len(glob) != 1:
        raise AssertionError(f"W3: global loads per instance {ldg}; "
                             "expected one instance of each regime")
    if glob[0] - shared[0] != 1:
        raise AssertionError(f"W3: global loads per instance {ldg}; the "
                             "shared-adjacency one should read one fewer")
    entry, regimes = None, set()
    for dims in W3_CELLS:
        mesh, x, elem, dest = inputs = w3_setup(dims)
        L, dev = mesh.nelems, x.device
        regime = W3_REGIMES.get(dims, "shared adjacency")
        if w3_regime(L) != regime:
            raise AssertionError(f"W3 (L={L}): regime {w3_regime(L)!r}, "
                                 f"expected {regime!r}")
        regimes.add(regime)
        fly = torch.ones((K3_N,), dtype=torch.int8, device=dev)
        w = torch.ones((K3_N,), dtype=torch.float32, device=dev)
        kw = dict(tol=r3_vmem.TOL, max_iters=r3_vmem.MAX_ITERS)

        def run(fn):
            flux = torch.zeros((L,), dtype=torch.float32, device=dev)
            return fn(mesh, x, elem, dest, fly, w, flux, **kw)

        rk, rp = run(r3_vmem.walk_vmem), run(r3_vmem.walk_vmem_plain)
        sync()
        for f in ("elem", "done", "exited", "x", "s"):
            check_equal(f"W3 (L={L}) {f}", getattr(rk, f), getattr(rp, f))
        err_f = check_flux(f"W3 (L={L})", rk.flux, rp.flux)
        t = w3_times(inputs, passes=1)
        if t["walked"] != K3_N:
            raise AssertionError(f"W3 (L={L}): the kernel walked "
                                 f"{t['walked']} particles, not {K3_N}")
        ms = t["ms"][0]
        plain_ms = wall_ms(lambda: run(r3_vmem.walk_vmem_plain))
        bound = {k: t[k] for k in ("bound_ms", "bound_by")}
        print(f"# W3 (L={L}, {t['regime']}, N={K3_N}): {ms:.4f} ms kernel "
              f"(profiler), {t['entry_ms']:.4f} ms a walk_vmem call (events), "
              f"{plain_ms:.3f} ms plain, W0 {t['w0_ms']:.4f} ms "
              f"(profiler) on the same input; {t['crossings']} crossings, "
              f"{t['sm_cycles_per_crossing'][0]:.2f} SM cycles per "
              f"crossing, lanes busy {t['busy_share']:.3f} "
              f"({t['warp_steps']} warp steps); walked {t['walked']} of "
              f"{K3_N}; x, s bitwise; flux max abs diff {err_f:.3e}; bound "
              f"{bound}")
        if L == 6 * max(r3_vmem.BENCH_DIVS) ** 3:  # the tool's largest mesh
            entry = {"name": f"W3 resident_walk (L={L})", "route": "cuda",
                     "source": "pumiumtally_tpu_torch/csrc/resident_walk.cu",
                     "replaces": "tools/exp_r3_vmem.py:172",
                     "launches": launches, "max_abs_err": err_f, "ms": ms,
                     "plain_ms": plain_ms, **bound, "library_ms": None}
    if regimes != set(W3_REGIMES.values()) | {"shared adjacency"}:
        raise AssertionError(f"W3: the cells ran the regimes {regimes}")
    return entry


def queued_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls, with CUDA
    events around calls queued behind a sleep kernel: the card runs them
    back to back, so host launch gaps are not timed, but every device
    operation of a call is (a wrapper's zero fills too)."""
    import torch

    fn()
    sync()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(20_000_000)  # ~10 ms: time to queue the calls
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def device_us(fn, reps: int = 100, name: str = "") -> float:
    """Device time per call of ``fn`` in microseconds: the summed
    duration of the device activities whose name contains ``name`` that
    torch.profiler records over ``reps`` calls. Unlike CUDA events
    around back-to-back calls it holds no host gaps, which matter for a
    kernel that takes less time on the card than its wrapper takes to
    launch it. The profiler now and then misses some or all of a
    window's device activity: a window whose count of such activities is
    not a positive multiple of ``reps`` is profiled again, twice at most;
    after three such windows ``queued_ms`` times the calls instead. Each
    retry prints a line."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync()
        spans = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and name in e.name]
        if spans and len(spans) % reps == 0:
            return sum(spans) / reps
        print(f"# profiler retry: {len(spans)} device activities named "
              f"{name!r} over {reps} calls; profiling again")
    us = queued_ms(fn, reps) * 1e3
    print(f"# profiler retry: it missed {name!r} in three windows; timed "
          f"with events behind a sleep kernel instead: {us:.3f} us a call")
    return us


def same_bits(what: str, got, want) -> None:
    """NaN at the same places and every other value bit for bit."""
    import torch

    nan = want.isnan()
    check_equal(f"{what} NaN mask", got.isnan(), nan)
    check_equal(what, got[~nan].view(torch.int32),
                want[~nan].view(torch.int32))


def g1_inputs(rows: int):
    """The probes' [E,W] table and ``rows`` in-range indices: the probes'
    own input at their T, else indices from seed 2."""
    import torch

    from pumiumtally_tpu_torch.experiments import pallas_gather as pg

    tab, idx = pg.probe_inputs("cuda")
    if rows != pg.T:
        idx = torch.as_tensor(np.random.default_rng(2).integers(
            0, pg.E, rows).astype(np.int32), device=tab.device)
    return tab, idx


def g1_times(tab, idx, fill: float, passes: int) -> dict:
    """G1's kernel time (microseconds, ``passes`` profiled passes) at
    this input beside its bytes bound, ``torch.index_select``'s time
    (the yardstick; nothing in the port calls it) and three yardsticks:
    an empty kernel (``torch.cuda._sleep(0)``, one thread reading the
    clock once), a fill of the [T, W] output (the gather's writes alone)
    and a contiguous device copy of T rows (the gather's bytes at the
    probes' shape; at T above the table's E rows it reads T rows where
    the gather reads at most E from memory, so it is no floor there).
    The bound counts each index read once, each distinct table row the
    indices name read once, and each output row written once. It calls
    only ``pallas_gather.gather``, as every checkout of the port has it."""
    import torch

    from pumiumtally_tpu_torch.experiments import pallas_gather as pg

    rows, width = idx.shape[0], tab.shape[1]
    reps = 100 if rows <= pg.T else 10
    us = [device_us(lambda: pg.gather(tab, idx, fill), reps, "row_gather")
          for _ in range(passes)]
    lib_us = device_us(lambda: torch.index_select(tab, 0, idx), reps)
    empty_us = device_us(lambda: torch.cuda._sleep(0), reps, "spin")
    # The copy's source: the table's first rows, or (more rows than the
    # table has) a contiguous [rows, W] tensor.
    src = (tab[:rows] if rows <= tab.shape[0]
           else torch.randn((rows, width), device=tab.device))
    dst = torch.empty_like(src)
    copy_us = device_us(lambda: dst.copy_(src), reps, "Memcpy")
    out = torch.empty((rows, width), dtype=tab.dtype, device=tab.device)
    fill_us = device_us(lambda: out.fill_(1.0), reps, "Fill")
    E = tab.shape[0]
    distinct = int(torch.unique(torch.where(idx < 0, idx + E, idx)).numel())
    nbytes = rows * 4 + (distinct + rows) * width * 4
    return {"E": E, "W": width, "T": rows, "distinct_rows": distinct,
            "us": us, "bound_us": bound_entry(nbytes, 0)["bound_ms"] * 1e3,
            "index_select_us": lib_us, "empty_kernel_us": empty_us,
            "fill_us": fill_us, "copy_us": copy_us}


def phase_g1() -> list:
    """G1 (csrc/row_gather.cu) through its experiment entry point, the
    probe ``pallas_gather.main`` in both fill modes (launches counted
    over those runs); then, at each of G1_ROWS, each mode against
    ``gather_plain`` bitwise on in-range indices and on wrapped and
    out-of-range ones, and its time (``g1_times``) beside its bound,
    ``torch.index_select`` and the two floors."""
    import torch

    from pumiumtally_tpu_torch import kernels
    from pumiumtally_tpu_torch.experiments import pallas_gather as pg

    kernels.reset_launch_counts()
    for variant in pg.VARIANTS:
        if not pg.main(variant)["ok"]:
            raise AssertionError(f"G1 {variant}: the probe's check failed")
    counts = dict(kernels.launch_counts)
    entries = []
    for rows in G1_ROWS:
        tab, idx = g1_inputs(rows)
        rng = np.random.default_rng(1)
        wild = rng.integers(-2 * pg.E, 2 * pg.E, rows)
        wild[:6] = [0, pg.E - 1, -1, -pg.E, pg.E, -pg.E - 1]
        wild = torch.as_tensor(wild.astype(np.int32), device=tab.device)
        for variant, (tool, line) in (("take", ("exp_pallas_gather.py", 14)),
                                      ("take_along_axis",
                                       ("exp_pallas_gather2.py", 15))):
            fill = pg.VARIANTS[variant][1]
            for ix in (idx, wild):
                same_bits(f"G1 {variant} (T={rows})",
                          pg.gather(tab, ix, fill),
                          pg.gather_plain(tab, ix, fill))
            t = g1_times(tab, idx, fill, passes=1)
            plain_ms = wall_ms(lambda: pg.gather_plain(tab, idx, fill))
            entry_name = f"row_gather_{variant}"
            print(f"# G1 {variant} ([{pg.E},{pg.W}] f32, {rows} rows): "
                  f"{t['us'][0]:.3f} us kernel, bound {t['bound_us']:.3f} us "
                  f"(bytes), torch.index_select {t['index_select_us']:.3f} "
                  f"us, empty kernel {t['empty_kernel_us']:.3f} us, "
                  f"output fill {t['fill_us']:.3f} us, contiguous copy of "
                  f"T rows {t['copy_us']:.3f} us (profiler); "
                  f"{plain_ms:.3f} ms plain; bitwise incl. wrapped and "
                  f"out-of-range indices")
            if rows != pg.T:
                continue
            if counts[entry_name] == 0:
                raise AssertionError(f"G1: the probe never launched "
                                     f"{entry_name}")
            entries.append({
                "name": f"G1 {entry_name}", "route": "cuda",
                "source": "pumiumtally_tpu_torch/csrc/row_gather.cu",
                "replaces": f"tools/{tool}:{line}",
                "launches": counts[entry_name], "max_abs_err": 0.0,
                "ms": t["us"][0] / 1e3, "plain_ms": plain_ms,
                "bound_ms": t["bound_us"] / 1e3, "bound_by": "bytes",
                "library_ms": t["index_select_us"] / 1e3})
    return entries


def phase_oracle() -> None:
    """The reference's 6-tet cube oracle (tests/test_walk_oracle.py) in
    float64 through both facades on the card."""
    import torch

    from pumiumtally_tpu_torch import (
        PartitionedPumiTally,
        PumiTally,
        TallyConfig,
        build_box,
    )

    num = 5
    init = np.tile([0.1, 0.4, 0.5], (num, 1))
    dests = np.tile([1.2, 0.4, 0.5], (num, 1))
    origins2 = np.tile([1.0, 0.4, 0.5], (num, 1))
    next_pos = origins2.copy()
    flying2 = np.zeros(num, dtype=np.int8)
    weights2 = np.ones(num)
    next_pos[0], flying2[0], weights2[0] = [0.15, 0.05, 0.20], 1, 2.0
    next_pos[2], flying2[2], weights2[2] = [0.85, 0.05, 0.10], 1, 0.5
    expected1 = np.array([0.0, 0.0, 0.3 * num, 0.1 * num, 0.5 * num, 0.0])
    expected2 = expected1.copy()
    expected2[3] += 0.08790490988459178 * 2.0
    expected2[4] += 0.879049070406094 * 2.0 + 0.552268050859363 * 0.5

    mesh = build_box(1, 1, 1, 1, 1, 1, dtype=torch.float64)
    for t in (PumiTally(mesh, num),
              PartitionedPumiTally(mesh, num,
                                   TallyConfig(walk_vmem_max_elems=2))):
        kind = type(t).__name__
        t.CopyInitialPosition(flat(init), 3 * num)
        np.testing.assert_array_equal(t.elem_ids, np.full(num, 2), kind)
        fly = np.ones(num, dtype=np.int8)
        t.MoveToNextLocation(flat(init), flat(dests), fly, np.ones(num))
        np.testing.assert_array_equal(fly, 0, kind)
        np.testing.assert_array_equal(t.elem_ids, np.full(num, 4), kind)
        np.testing.assert_allclose(t.positions, origins2, atol=ORACLE_TOL)
        np.testing.assert_allclose(t.flux.cpu().numpy(), expected1,
                                   atol=ORACLE_TOL, err_msg=kind)
        t.MoveToNextLocation(flat(origins2), flat(next_pos), flying2.copy(),
                             weights2)
        np.testing.assert_allclose(t.positions, next_pos, atol=ORACLE_TOL)
        np.testing.assert_array_equal(t.elem_ids, [3, 4, 4, 4, 4], kind)
        np.testing.assert_allclose(t.flux.cpu().numpy(), expected2,
                                   atol=ORACLE_TOL, err_msg=kind)
    print("# oracle: 6-tet cube, float64, both facades on the card: ok at "
          f"{ORACLE_TOL}")


def phase_main_path(facade, mesh, pts, config, card: str,
                    n=None) -> tuple:
    """CopyInitialPosition, one two-phase move, then continue moves of n
    particles (the first n of ``pts``' rows); conservation, output file,
    launch counts, rate. ``mesh`` is a TetMesh or a mesh file's path.
    Returns the launch counts, the flux after the continue moves and the
    facade (after one more, profiled, continue move)."""
    from pumiumtally_tpu_torch import kernels

    n = N if n is None else n
    pts = [p[:n] for p in pts]
    kernels.reset_launch_counts()
    t = facade(mesh, n, config)
    t.CopyInitialPosition(flat(pts[0]))
    t.MoveToNextLocation(flat(pts[0]), flat(pts[1]),
                         np.ones(n, np.int8), np.ones(n))
    move_ms = []
    for m in range(2, CONTINUE_MOVES + 2):
        move_ms.append(wall_ms(
            lambda m=m: t.MoveToNextLocation(None, flat(pts[m]))
        ))
    dt = sum(move_ms) / 1e3
    counts = dict(kernels.launch_counts)
    expect = sum(float(np.linalg.norm(pts[m] - pts[m - 1], axis=1).sum())
                 for m in range(1, CONTINUE_MOVES + 2))
    rel = check_conservation(facade.__name__, t.flux, expect)
    flux = t.flux.double().clone()
    with tempfile.TemporaryDirectory() as d:
        t.WriteTallyResults(f"{d}/fluxresult.vtk")
    rate = n * CONTINUE_MOVES / dt
    tier = config.resolved_table_dtype()
    print(f"# main path {facade.__name__} ({tier} tables): {rate:.1f} "
          f"moves/s on {card} "
          f"over "
          f"{CONTINUE_MOVES} continue moves of {n} particles on "
          f"{t.mesh.nelems} tets (per move ms: "
          f"{', '.join(f'{v:.3f}' for v in move_ms)}); conservation rel "
          f"err {rel:.3e}; launches {counts}")
    profile_move(t, pts[CONTINUE_MOVES + 2])
    return counts, flux, t


def phase_partitioned_default(mesh, pts, card: str) -> dict:
    """Phase 10's ``PartitionedPumiTally`` with a default config (one
    block of the whole box, W4) through ``phase_main_path``, then a
    profiled continue move (``PhaseProfile``: walk, migration, occupancy
    and bookkeeping sections); the same with the bf16 tables and the
    vmem knobs (rerouted to W4's two-tier variant); ``cap_frontier=4096``
    against the default on one block and on the gather sub-split,
    positions and ids equal (fallback rounds reported); and a forced
    overflow (corner-bound destinations, capacity_factor 1.3, the gather
    sub-split, PART_OVERFLOW_N particles) that the ladder recovers, with
    conservation. Returns each main-path run's launch counts."""
    import torch

    from pumiumtally_tpu_torch import PartitionedPumiTally, TallyConfig
    from pumiumtally_tpu_torch.parallel.partition import PhaseProfile

    counts = {}
    base = dict(capacity_factor=CAPACITY_FACTOR)  # the sub-splits'
    counts["part_default"], _, t = phase_main_path(
        PartitionedPumiTally, mesh, pts, TallyConfig(), card)
    if t.engine.nparts != 1 or t.engine.use_vmem_walk:
        raise AssertionError("the default partitioned facade is not one W4 "
                             "block")
    eng, dev = t.engine, t.device
    prof = PhaseProfile()
    dests = torch.as_tensor(pts[2], dtype=torch.float32, device=dev)
    ones = torch.ones((N,), dtype=torch.float32, device=dev)
    wall = wall_ms(lambda: eng.move(None, dests, ones.to(torch.int8), ones,
                                    profile=prof))
    print(f"# PhaseProfile of one continue move, default partitioned "
          f"facade: wall {wall:.3f} ms, {json.dumps(prof.as_dict())}")
    counts["part_gather_bf16"], _, tb = phase_main_path(
        PartitionedPumiTally, mesh, pts, TallyConfig(
            walk_vmem_max_elems=VMEM_BOUND, **BF16, **base), card)
    if tb.engine.block_kernel != "gather" or not tb.engine.two_tier:
        raise AssertionError("bf16 + vmem did not reroute to W4")
    del t, tb
    for label, knobs in (("one block", {}),
                         ("sub-split", dict(walk_vmem_max_elems=VMEM_BOUND,
                                            walk_block_kernel="gather",
                                            **base))):
        runs = []
        for cf in (None, 4096):
            tf = PartitionedPumiTally(mesh, N, TallyConfig(
                cap_frontier=cf, check_found_all=False, **knobs))
            tf.CopyInitialPosition(flat(pts[0]))
            tf.MoveToNextLocation(flat(pts[0]), flat(pts[1]),
                                  np.ones(N, np.int8), np.ones(N))
            for m in range(2, CONTINUE_MOVES + 2):
                tf.MoveToNextLocation(None, flat(pts[m]))
            runs.append((tf.positions, tf.elem_ids, tf.engine))
            del tf
        if not (np.array_equal(runs[0][0], runs[1][0])
                and np.array_equal(runs[0][1], runs[1][1])):
            raise AssertionError(f"cap_frontier=4096 ({label}): positions "
                                 "or ids differ from the default's")
        e = runs[1][2]
        print(f"# cap_frontier=4096 ({label}, {e.nparts} blocks): positions "
              f"and ids equal the default run's; last phase "
              f"{e.last_walk_rounds} rounds, front max "
              f"{e.last_frontier_max}, {e.last_fallback_rounds} fallback "
              f"rounds")
    rng = np.random.default_rng(8)
    n = PART_OVERFLOW_N
    src = rng.uniform(0.05, 0.95, (n, 3))
    corner = rng.uniform(0.02, 0.12, (n, 3))
    to = PartitionedPumiTally(mesh, n, TallyConfig(
        walk_vmem_max_elems=VMEM_BOUND, walk_block_kernel="gather",
        capacity_factor=1.3, check_found_all=False))
    cap0 = to.engine.cap_per_block
    to.CopyInitialPosition(flat(src))
    wall = wall_ms(lambda: to.MoveToNextLocation(None, flat(corner)))
    e = to.engine
    rel = check_conservation("forced overflow", to.flux,
                             float(np.linalg.norm(corner - src,
                                                  axis=1).sum()))
    if e.overflow_recoveries < 1 or e.poisoned:
        raise AssertionError(f"forced overflow: {e.overflow_recoveries} "
                             f"recoveries, poisoned {e.poisoned}")
    print(f"# forced overflow ({n} particles into one corner, "
          f"{e.nparts} blocks, capacity_factor 1.3): recovered, "
          f"{e.overflow_recoveries} recoveries, {e.capacity_escalations} "
          f"escalations, {cap0} -> {e.cap_per_block} slots a block; the "
          f"move {wall:.1f} ms; conservation rel err {rel:.3e}")
    return counts



def profile_move(t, dests: np.ndarray, move_kw=None) -> None:
    """Where one continue move's time goes: wall time on the host clock,
    device-busy time as the union of the device activity intervals that
    torch.profiler records (kernels and copies; the CPU ops that launch
    them are not counted again), and the device activities that take
    most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pumiumtally_tpu_torch import kernels

    before = dict(kernels.launch_counts)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        t.MoveToNextLocation(None, flat(dests), **(move_kw or {}))
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us = span_us(union(device_spans(prof)))
    name = type(t).__name__ + (" (scoring)" if move_kw else "")
    if busy_us == 0:
        print(f"# profile {name}: wall {wall_ms:.3f} ms; device time not "
              "measured (the profiler saw none)")
        return
    print(f"# profile {name}: one continue move, wall {wall_ms:.3f} ms "
          f"(under the profiler), device busy {busy_us / 1e3:.3f} ms, "
          f"idle share {1 - busy_us / 1e3 / wall_ms:.3f}")
    totals = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = totals.get(e.name, (0, 0.0))
            totals[e.name] = (n + 1, us + e.time_range.elapsed_us())
    for key, (n, us) in sorted(totals.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"#   {us / 1e3:9.3f} ms  x{n:<5d} {key[:90]}")
    walks = sorted((e.time_range.start, e.time_range.elapsed_us() / 1e3)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "block_walk_kernel" in e.name)
    if walks:
        # The profiler now and then misses kernels: the wrappers' own
        # count of this move's launches stands beside its list.
        launched = sum(kernels.launch_counts[k] - before[k]
                       for k in ("block_walk", "twotier_block_walk",
                                 "twotier_block_walk_scored",
                                 "gather_block_walk",
                                 "gather_block_walk_twotier",
                                 "gather_block_walk_scored",
                                 "gather_block_walk_twotier_scored"))
        print(f"#   block walk per round (ms): "
              f"{', '.join(f'{ms:.4f}' for _, ms in walks)}; "
              f"{len(walks)} launches profiled of {launched} made, "
              f"{sum(ms for _, ms in walks):.4f} ms per move")


def device_spans(prof, kind: str = "all") -> list:
    """(start, end) in microseconds of the device activities a
    torch.profiler window recorded: ``kind`` "all", "h2d" (host-to-device
    copies) or "kernels" (everything but copies and fills)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        is_h2d = e.name.startswith("Memcpy HtoD")
        is_kernel = not e.name.startswith(("Memcpy", "Memset"))
        if kind == "all" or (kind == "h2d" and is_h2d) or (
                kind == "kernels" and is_kernel):
            out.append((e.time_range.start, e.time_range.end))
    return out


def union(spans) -> list:
    """Disjoint, sorted intervals covering ``spans``."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def span_us(spans) -> float:
    return sum(b - a for a, b in spans)


def overlap_us(u, v) -> float:
    """Time covered by both of two unions of intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(u) and j < len(v):
        lo, hi = max(u[i][0], v[j][0]), min(u[i][1], v[j][1])
        total += max(0.0, hi - lo)
        if u[i][1] < v[j][1]:
            i += 1
        else:
            j += 1
    return total


def phase_w0_skip(mesh, pts) -> None:
    """W0's ``skip`` flag (the JAX move's device-side phase-A skip), on
    both tiers: set, the kernel walks no particle (its count stays 0)
    and returns its inputs bitwise, equal to ``walk_plain(skip=...)``;
    clear, it walks all n."""
    for two_tier in (False, True):
        w0_skip(*w0_inputs(mesh, pts, two_tier))
    print(f"# W0 skip, both tiers: set, 0 particles walked, x/elem/s "
          f"returned bitwise (with and without s_init), equal to "
          f"walk_plain; clear, {N} walked")


def w0_skip(args, kw) -> None:
    import torch

    from pumiumtally_tpu_torch.ops.walk import walk, walk_plain

    m, x, elem = args[:3]
    dev = x.device
    for s_init in (None, torch.full((N,), 0.25, device=dev)):
        flux = torch.zeros((m.nelems,), dtype=x.dtype, device=dev)
        counts = torch.zeros((1,), dtype=torch.int32, device=dev)
        yes = torch.ones((), dtype=torch.bool, device=dev)
        rk = walk(*args, flux, **kw, s_init=s_init, counts=counts, skip=yes)
        rp = walk_plain(*args, torch.zeros_like(flux), **kw, s_init=s_init,
                        skip=yes)
        sync()
        for f in ("x", "elem", "done", "exited", "s", "iters"):
            check_equal(f"W0 skip {f}", getattr(rk, f), getattr(rp, f))
        check_equal("W0 skip x is the input", rk.x, x)
        check_equal("W0 skip elem is the input", rk.elem, elem)
        if int(counts[0]) != 0 or bool(flux.any()):
            raise AssertionError(f"W0 skip: walked {int(counts[0])} "
                                 "particles or tallied")
    counts.zero_()
    walk(*args, torch.zeros_like(flux), **kw, counts=counts,
         skip=torch.zeros((), dtype=torch.bool, device=dev))
    if int(counts[0]) != N:
        raise AssertionError(f"W0 skip clear: walked {int(counts[0])} of {N}")


def phase_staging(mesh, pts) -> None:
    """The staging knobs at N particles. With ``check_found_all=False,
    fenced_timing=False``, an echoing two-phase move and a continue move
    each run under ``torch.cuda.set_sync_debug_mode("error")`` (any host
    synchronization raises) behind ~50 ms of queued device work, and
    must return while that still runs. Then the protocol (localize, two
    two-phase moves, the second echoing, a continue move) with the echo
    on and off, fenced and not, validated and not: positions bitwise,
    ids equal, flux at rtol 1e-4 against the defaults' run."""
    import torch

    from pumiumtally_tpu_torch import PumiTally, TallyConfig, kernels

    def fly():
        return np.ones(N, np.int8)

    t = PumiTally(mesh, N, TallyConfig(check_found_all=False,
                                       fenced_timing=False))
    t.CopyInitialPosition(flat(pts[0]))
    t.MoveToNextLocation(flat(pts[0]), flat(pts[1]), fly(), np.ones(N))
    calls = (
        ("echoing two-phase move",
         lambda: t.MoveToNextLocation(flat(pts[1]), flat(pts[2]), fly(),
                                      np.ones(N))),
        ("continue move", lambda: t.MoveToNextLocation(None, flat(pts[3]))),
    )
    for label, call in calls:
        sync()
        before = dict(kernels.launch_counts)
        torch.cuda._sleep(SLEEP_CYCLES)
        ahead = torch.cuda.Event()
        ahead.record()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            call()
            host_ms = (time.perf_counter() - t0) * 1e3
            busy = not ahead.query()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if not busy:
            raise AssertionError(f"staging: the {label} returned after the "
                                 "device work queued ahead of it had ended")
        launched = {k: kernels.launch_counts[k] - v
                    for k, v in before.items() if kernels.launch_counts[k] > v}
        print(f"# staging: {label}, unfenced and unchecked: no host "
              f"synchronization (sync debug mode 'error'), returned after "
              f"{host_ms:.3f} ms with the ~50 ms queued ahead still running; "
              f"launches {launched}")
    sync()
    if t.auto_continue_hits != 1:
        raise AssertionError(f"staging: {t.auto_continue_hits} echo hits, "
                             "not 1")
    base = None
    for auto, fenced, validate in ((True, True, True), (False, True, True),
                                   (True, False, True), (False, False, True),
                                   (True, False, False)):
        t = PumiTally(mesh, N, TallyConfig(
            check_found_all=False, auto_continue=auto,
            fenced_timing=fenced, validate_inputs=validate))
        t.CopyInitialPosition(flat(pts[0]))
        t.MoveToNextLocation(flat(pts[0]), flat(pts[1]), fly(), np.ones(N))
        t.MoveToNextLocation(flat(pts[1]), flat(pts[2]), fly(), np.ones(N))
        t.MoveToNextLocation(None, flat(pts[3]))
        sync()
        if t.auto_continue_hits != int(auto):
            raise AssertionError(f"staging: {t.auto_continue_hits} echo "
                                 f"hits with auto_continue={auto}")
        got = (t.positions, t.elem_ids, t.flux.clone())
        label = (f"auto_continue={auto}, fenced_timing={fenced}, "
                 f"validate_inputs={validate}")
        if base is None:
            base = got
            continue
        if not np.array_equal(got[0], base[0]):
            raise AssertionError(f"staging {label}: positions differ")
        if not np.array_equal(got[1], base[1]):
            raise AssertionError(f"staging {label}: ids differ")
        check_flux(f"staging {label}", got[2], base[2])
    print("# staging: echo on/off x fenced/unfenced (and unvalidated): "
          "positions bitwise, ids equal, flux within rtol 1e-4 of the "
          "defaults' run")


def trajectory_moves(seed: int, n: int):
    """bench.py's trajectory (``make_trajectory``), one array at a time:
    yields the source points, then each move's destinations."""
    from pumiumtally_tpu_torch.experiments.block_rounds import MEAN_STEP

    rng = np.random.default_rng(seed)
    p = rng.uniform(0.05, 0.95, (n, 3))
    while True:
        yield p
        step = rng.normal(scale=MEAN_STEP / np.sqrt(3.0), size=(n, 3))
        p = np.clip(p + step, 0.02, 0.98)


def contains(mesh, pts, elem, tol: float):
    """Whether each point lies in its element within ``tol`` (the
    half-space test on the element's four planes)."""
    import torch

    p = torch.as_tensor(pts, dtype=mesh.dtype, device=mesh.device)
    e = torch.as_tensor(elem, dtype=torch.long, device=mesh.device)
    proj = (mesh.face_normals[e] * p[:, None, :]).sum(dim=2)
    return (proj <= mesh.face_offsets[e] + tol).all(dim=1).cpu().numpy()


def phase_streaming(mesh, card: str) -> dict:
    """The streaming cell: STREAM_N particles on the box in
    STREAM_CHUNK chunks. ``StreamingTally`` on both tiers and
    ``StreamingPartitionedTally`` (W1) beside ``PumiTally`` on both
    tiers, in lockstep on one trajectory generated a move at a time:
    CopyInitialPosition, one two-phase move, then continue moves (the
    partitioned one stops after STREAM_PART_CONTINUE_MOVES). Held:
    streaming against monolithic ids equal, positions bitwise, flux at
    rtol 1e-4; every facade's conservation at rtol 1e-6; the partitioned
    ids equal to the monolithic ones but for face ties (a point within
    the tolerance of both elements), its W1 launches > 0. Then one
    profiled continue move of the float32 ``StreamingTally``: idle
    share, and the host-to-device copy time that overlaps kernel time
    (the double buffering), which must be > 0. Returns each run's launch
    counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pumiumtally_tpu_torch import (
        PumiTally,
        StreamingPartitionedTally,
        StreamingTally,
        TallyConfig,
        kernels,
    )

    n = STREAM_N
    t0 = time.perf_counter()
    chunked = dict(chunk_size=STREAM_CHUNK)
    facades = {
        "stream": StreamingTally(mesh, n, config=TallyConfig(), **chunked),
        "stream_bf16": StreamingTally(mesh, n, config=TallyConfig(**BF16),
                                      **chunked),
        "stream_part": StreamingPartitionedTally(
            mesh, n, config=TallyConfig(capacity_factor=CAPACITY_FACTOR,
                                        walk_vmem_max_elems=VMEM_BOUND),
            **chunked),
        "mono_10m": PumiTally(mesh, n, TallyConfig()),
        "mono_10m_bf16": PumiTally(mesh, n, TallyConfig(**BF16)),
    }
    counts = {k: dict.fromkeys(kernels.launch_counts, 0) for k in facades}
    move_ms = {k: [] for k in facades}
    setup_ms = {}  # CopyInitialPosition and the two-phase move

    def call(key, method, *args):
        before = dict(kernels.launch_counts)
        ms = wall_ms(lambda: getattr(facades[key], method)(*args))
        for k, v in kernels.launch_counts.items():
            counts[key][k] += v - before[k]
        return ms

    traj = trajectory_moves(0, n)
    prev = next(traj)
    print(f"# streaming cell: facades built in "
          f"{time.perf_counter() - t0:.1f} s")
    for key in facades:
        setup_ms[key] = [call(key, "CopyInitialPosition", flat(prev))]
    expect = 0.0
    for m in range(1 + STREAM_CONTINUE_MOVES):
        cur = next(traj)
        expect += float(np.linalg.norm(cur - prev, axis=1).sum())
        for key in list(facades):
            if m == 0:  # the two-phase move (origins: the sources)
                setup_ms[key].append(call(
                    key, "MoveToNextLocation", flat(prev), flat(cur),
                    np.ones(n, np.int8), np.ones(n)))
            else:
                move_ms[key].append(call(key, "MoveToNextLocation", None,
                                         flat(cur)))
        if m == STREAM_PART_CONTINUE_MOVES:
            sp, mono = facades.pop("stream_part"), facades["mono_10m"]
            check_conservation("StreamingPartitionedTally", sp.flux, expect)
            ids_sp, ids = sp.elem_ids, mono.elem_ids
            diff = np.flatnonzero(ids_sp != ids)
            pos = mono.positions[diff]
            ties = (contains(mono.mesh, pos, ids_sp[diff], 1e-5)
                    & contains(mono.mesh, pos, ids[diff], 1e-5))
            if not ties.all():
                raise AssertionError(
                    f"StreamingPartitionedTally: {int((~ties).sum())} ids "
                    "differ from PumiTally's outside a face tie")
            print(f"# streaming partitioned (W1, {len(sp.engines)} chunk "
                  f"engines, {sp.engines[0].nparts} blocks): ids equal to "
                  f"PumiTally's at {n} particles but {diff.size} face ties; "
                  f"conserving; launches {counts['stream_part']}")
            del sp
        prev = cur
    sync()
    for tier in ("", "_bf16"):
        st, mono = facades[f"stream{tier}"], facades[f"mono_10m{tier}"]
        label = f"StreamingTally{tier or ' (float32)'}"
        check_equal(f"{label} ids", torch.as_tensor(st.elem_ids),
                    torch.as_tensor(mono.elem_ids))
        check_equal(f"{label} positions", torch.as_tensor(st.positions),
                    torch.as_tensor(mono.positions))
        check_flux(label, st.flux, mono.flux)
        for t, name in ((st, label), (mono, f"PumiTally{tier}")):
            check_conservation(name, t.flux, expect)
    for key, ms in move_ms.items():
        print(f"# streaming {key}: {n * len(ms) / (sum(ms) / 1e3):.1f} "
              f"moves/s on {card} over {len(ms)} continue moves of {n} "
              f"particles (per move ms: {', '.join(f'{v:.1f}' for v in ms)}"
              f"; CopyInitialPosition, two-phase move ms: "
              f"{', '.join(f'{v:.1f}' for v in setup_ms[key])})")
    # One profiled continue move of the float32 streaming facade.
    st = facades["stream"]
    cur = next(traj)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        st.MoveToNextLocation(None, flat(cur))
        sync()
        wall = (time.perf_counter() - t1) * 1e3
    busy = union(device_spans(prof))
    h2d, kern = (union(device_spans(prof, k)) for k in ("h2d", "kernels"))
    over = overlap_us(h2d, kern)
    print(f"# profile StreamingTally ({n} particles, {st.nchunks} chunks): "
          f"wall {wall:.3f} ms (under the profiler), device busy "
          f"{span_us(busy) / 1e3:.3f} ms, idle share "
          f"{1 - span_us(busy) / 1e3 / wall:.3f}; host-to-device copies "
          f"{span_us(h2d) / 1e3:.3f} ms, kernels {span_us(kern) / 1e3:.3f} "
          f"ms, copy time overlapping kernel time {over / 1e3:.3f} ms")
    if not over > 0:
        raise AssertionError("StreamingTally: no host-to-device copy "
                             "overlapped a kernel (double buffering)")
    print(f"# streaming cell: {time.perf_counter() - t0:.1f} s in all")
    return counts


def check_conservation(what: str, flux, expect: float) -> float:
    """Total flux against the analytic track length, at rtol 1e-6;
    returns the relative error."""
    total = float(flux.double().sum())
    rel = abs(total - expect) / expect
    if rel > CONSERVATION_RTOL:
        raise AssertionError(f"{what}: conservation off by {rel:.3e} "
                             f"(got {total}, want {expect})")
    return rel


def lattice_box() -> list:
    """The lattice's bounding box (its lower corner is the origin)."""
    from pumiumtally_tpu_torch.mesh.pincell import FLAGSHIP_PINCELL

    return [LATTICE[0] * FLAGSHIP_PINCELL["pitch"],
            LATTICE[1] * FLAGSHIP_PINCELL["pitch"],
            FLAGSHIP_PINCELL["height"]]


def write_lattice(directory: str) -> tuple:
    """The 3x3 lattice written with the port's ``write_osh``: its path,
    and bench.py's trajectory over its box (``run_pincell``'s seed)."""
    from pumiumtally_tpu_torch.experiments.block_rounds import (
        make_trajectory,
    )
    from pumiumtally_tpu_torch.io.osh import write_osh
    from pumiumtally_tpu_torch.mesh.pincell import (
        FLAGSHIP_PINCELL,
        lattice_arrays,
    )

    params = dict(FLAGSHIP_PINCELL, nz=LATTICE_NZ)
    t0 = time.perf_counter()
    coords, tets, _, _ = lattice_arrays(*LATTICE, **params)
    path = f"{directory}/lattice.osh"
    write_osh(path, coords, tets)
    box = lattice_box()
    print(f"# lattice: {LATTICE[0]}x{LATTICE[1]} FLAGSHIP_PINCELL cells, "
          f"nz={LATTICE_NZ}: {tets.shape[0]} tets, {coords.shape[0]} "
          f"vertices, box {box}; generated and written as .osh in "
          f"{time.perf_counter() - t0:.1f} s")
    pts = make_trajectory(np.random.default_rng(1), N, CONTINUE_MOVES + 2,
                          box=box)
    return path, pts


def check_tie_band(what: str, flux_bf16, flux_f32, band=TIE_BAND) -> None:
    """Two-tier vs float32 flux: on the box, face ties below bf16
    precision move track length between neighbouring tets, within the
    tie-class band. ``band=None`` reports the L1 only."""
    l1 = float((flux_bf16 - flux_f32).abs().sum()) / float(flux_f32.sum())
    print(f"# two-tier vs float32 flux ({what}): L1 {l1:.3e} of the total "
          f"track length")
    if band is not None and l1 > band:
        raise AssertionError(f"{what}: two-tier flux L1 {l1} outside the "
                             f"tie-class band {TIE_BAND}")


# The scoring phase's spec (8 energy bins x 4 time bins x 3 scores:
# stride 96) and its inputs: energies log-uniform over the edges with
# SCORE_OUT of them below or above (the DROP sentinel), times uniform.
SCORE_E_EDGES = np.geomspace(1e-5, 2e7, 9)
SCORE_T_EDGES = np.linspace(0.0, 1.0, 5)
SCORE_NAMES = ("flux", "heating", "events")
SCORE_OUT = 0.01
SCORE_BATCHES = 3
SCORE_PASSES = 4  # scoring-on / scoring-off timing passes
# The scoring commit's edge cases (phase 6c): S = 1, 2 and 3 scores over
# 3 energy bins (strides 3, 6 and 9: odd, even, odd), the energies of
# SCORE_E_EDGES' range; EDGE_LEAD particles walk out of the last element
# in its last bin.
EDGE_E_EDGES = np.geomspace(SCORE_E_EDGES[0], SCORE_E_EDGES[-1], 4)
EDGE_SCORES = (("flux",), ("flux", "events"), ("flux", "heating", "events"))
EDGE_LEAD = 64
EDGE_ROUNDS = 2  # W2's rounds per edge case: the leads score in round 1
# The scoring-off instantiations' registers (ptxas, sm_90a, this
# script's flags) as walk.cu and twotier_block_walk.cu built them before
# they had any scoring code: scoring must not move them.
# W0's kLayout template values (csrc/walk.cu WALK_PACKED, WALK_TWO_TIER,
# WALK_ROW16, WALK_ROW20).
WALK_LAYOUTS = ("packed", "two-tier", "row16", "row20")
# Registers of W0's packed and two-tier instantiations, (dtype, layout,
# scoring, deterministic, segmented) -> ptxas's count, as walk.cu built
# them before the unpacked layouts had compile-time widths: a layout
# added beside them must not raise them.
REGS_PACKED_BEFORE = {
    (dtype, layout, score, det, seg): regs
    for (dtype, layout), counts in {
        ("float", "packed"): (54, 55, 64, 64, 59, 58, 69, 76),
        ("float", "two-tier"): (44, 46, 56, 58, 48, 48, 60, 62),
        ("double", "packed"): (89, 89, 102, 103, 95, 95, 109, 110),
        ("double", "two-tier"): (64, 64, 77, 77, 71, 73, 84, 86),
    }.items()
    for (score, det, seg), regs in zip(
        [(sc, d, sg) for sc in (False, True) for d in (False, True)
         for sg in (False, True)], counts)
}
# 16-byte loads of one crossing's planes and ids, per unpacked layout and
# dtype: ROW16 4 float4 (8 double2) and the int4 of ids, ROW20 the 80 B
# (160 B) block.
PLANE_VECTOR_LOADS = {("row16", "float"): 5, ("row16", "double"): 9,
                      ("row20", "float"): 5, ("row20", "double"): 10}
REGS_BEFORE_SCORING = {
    ("walk", "float", "packed"): 54,
    ("walk", "float", "two-tier"): 44,
    ("walk", "double", "packed"): 89,
    ("walk", "double", "two-tier"): 64,
    ("twotier_block_walk", "float", ""): 55,
    ("twotier_block_walk", "double", ""): 64,
}


def score_spec():
    from pumiumtally_tpu_torch import EnergyFilter, ScoringSpec, TimeFilter

    return ScoringSpec([EnergyFilter(SCORE_E_EDGES),
                        TimeFilter(SCORE_T_EDGES)], SCORE_NAMES)


def edge_specs() -> list:
    from pumiumtally_tpu_torch import EnergyFilter, ScoringSpec

    return [ScoringSpec([EnergyFilter(EDGE_E_EDGES)], names)
            for names in EDGE_SCORES]


def phase_score_edges(mesh, pts) -> None:
    """Phase 6c: the scoring commit's edge cases. Each spec of
    ``edge_specs`` (S = 1, 2, 3; strides 3, 6, 9) through W0 on both
    tiers in float32 (500,000 particles) and float64 (100,000) and W2 in
    both regimes (rounds 1-2), each against its plain version, with
    particles that score the last element's last lane; float32 kernels
    on two bank alignments."""
    import torch

    from pumiumtally_tpu_torch import build_box

    t0 = time.perf_counter()
    box64 = build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                      dtype=torch.float64)
    for m, n, dtype in ((mesh, N, ""), (box64, W0_F64_N, " (float64)")):
        for two_tier in (False, True):
            inputs = w0_inputs(m, pts, two_tier, n)
            for spec in edge_specs():
                phase_w0_scoring(m, pts, f" (edge, S={spec.n_scores}){dtype}",
                                 two_tier, n=n, spec=spec, edge=True,
                                 inputs=inputs)
    for spec in edge_specs():
        phase_w2_scoring(mesh, pts, VMEM_BOUND, True, spec=spec, edge=True)
        phase_w2_scoring(mesh, pts, None, False, spec=spec, edge=True)
    print(f"# scoring commit edge cases: {time.perf_counter() - t0:.1f} s")


def score_attrs(seed: int, n: int, out: float = SCORE_OUT) -> tuple:
    """(energy, time) for n particles from ``seed``: log-uniform energies
    over the edges, a share ``out`` of them a decade below or above."""
    rng = np.random.default_rng(seed)
    lo, hi = np.log10(SCORE_E_EDGES[0]), np.log10(SCORE_E_EDGES[-1])
    energy = 10.0 ** rng.uniform(lo, hi, n)
    pick = rng.random(n)
    energy = np.where(pick < out / 2, SCORE_E_EDGES[0] / 10, energy)
    energy = np.where(pick > 1 - out / 2, SCORE_E_EDGES[-1] * 10, energy)
    return energy, rng.uniform(0.0, 1.0, n)


def instance_registers(lib: str) -> dict:
    """(dtype, variant, scoring, deterministic, segmented) -> registers of
    each instantiation of the library's walk kernel, from ptxas's report:
    variant "packed", "two-tier" or "unpacked" for W0, "" for W2 (which
    has no segmented instantiation)."""
    from pumiumtally_tpu_torch import kernels

    out, key = {}, None
    for line in kernels.build_log(lib).splitlines():
        if "properties for" in line and instance_key(lib, line):
            key = instance_key(lib, line)
        elif key and "Used" in line and "registers" in line:
            out[key] = int(re.search(r"Used (\d+) registers", line)[1])
            key = None
    return out


def instance_key(lib: str, text: str):
    """(dtype, variant, scoring, deterministic, segmented) of the walk
    kernel instantiation a mangled name in ``text`` names
    (``instance_registers``' keys), or None."""
    pat = (r"_Z\d+walk_kernelI(\w)Li(\d)ELb(\d)ELb(\d)ELb(\d)E"
           if lib == "walk"
           else r"_Z\d+twotier_block_walk_kernelI(\w)Lb(\d)ELb(\d)E")
    m = re.search(pat, text)
    if not m:
        return None
    dtype = {"f": "float", "d": "double"}[m[1]]
    if lib == "walk":
        return (dtype, WALK_LAYOUTS[int(m[2])], bool(int(m[3])),
                bool(int(m[4])), bool(int(m[5])))
    return dtype, "", bool(int(m[2])), bool(int(m[3])), False


def float_reductions(ops: dict) -> tuple:
    """(vector, scalar) global float additions among one kernel's SASS
    opcode counts (``sass_counts``): REDG/ATOMG ``.ADD.F32x4`` and
    ``.F32x2`` against ``.ADD.F32`` and ``.ADD.F64``."""
    vec = sca = 0
    for op, c in ops.items():
        if re.match(r"(RED|ATOM)G\.E\.ADD\.F32x[24]", op):
            vec += c
        elif re.match(r"(RED|ATOM)G\.E\.ADD\.F(32|64)(\.|$)", op):
            sca += c
    return vec, sca


def phase_scoring_registers() -> None:
    """Registers of every instantiation, scoring off and on, atomic and
    deterministic commit (W0's and W2's kDet), W0 with and without the
    segmented commit (kSeg), beside its vector and scalar global float
    reductions in SASS (``cuobjdump``, required); the atomic,
    unsegmented scoring-off ones must equal REGS_BEFORE_SCORING, the
    float32 atomic scoring instantiations must issue vector reductions
    (the scoring commit's cover) and no other instantiation any, and the
    deterministic ones no float reduction at all (their commit is
    det_commit.cu's)."""
    for lib in ("walk", "twotier_block_walk"):
        regs = instance_registers(lib)
        sass = {instance_key(lib, fn): ops
                for fn, ops in sass_counts(lib).items()}
        if set(sass) != set(regs):
            raise AssertionError(f"{lib}: SASS of {sorted(sass, key=str)}, "
                                 f"ptxas reported {sorted(regs)}")
        for key, r in sorted(regs.items()):
            dtype, variant, score, det, seg = key
            vec, sca = float_reductions(sass[key])
            print(f"# registers {lib}<{dtype}> {variant or ''} scoring "
                  f"{'on' if score else 'off'}"
                  f"{', deterministic commit' if det else ''}"
                  f"{', segmented commit' if seg else ''}: {r}; global "
                  f"float reductions in SASS: {vec} vector, {sca} scalar")
            if lib == "walk" and r > REGS_PACKED_BEFORE.get(key, r):
                raise AssertionError(
                    f"walk<{dtype}> {variant} {key[2:]}: {r} registers, "
                    f"{REGS_PACKED_BEFORE[key]} before the unpacked "
                    "layouts' redesign")
            if det:
                if vec or sca:
                    raise AssertionError(
                        f"{lib}<{dtype}> {variant} deterministic: {vec} "
                        f"vector and {sca} scalar float reductions")
                continue
            # The unpacked instantiations came after scoring: no record.
            want = REGS_BEFORE_SCORING.get((lib, dtype, variant), r)
            if not score and not seg and r != want:
                raise AssertionError(
                    f"{lib}<{dtype}> {variant}: the scoring-off "
                    f"instantiation uses {r} registers, {want} before "
                    "scoring")
            if (vec > 0) != (score and dtype == "float"):
                raise AssertionError(
                    f"{lib}<{dtype}> {variant} scoring "
                    f"{'on' if score else 'off'}: {vec} vector reductions")
        if len(regs) != (16 * len(WALK_LAYOUTS) if lib == "walk" else 8):
            raise AssertionError(f"{lib}: ptxas reported {sorted(regs)}")


def phase_plane_loads() -> None:
    """Phase 2's check of W0's unpacked instantiations, from their SASS
    (``cuobjdump``, required): each reads its planes as whole 16-byte
    words, at least ``PLANE_VECTOR_LOADS`` 128-bit global loads, and no
    scalar plane load is left: its narrower global loads (the particle
    state) are no more than the packed instantiation's with the same
    scoring, commit and segment flags."""
    sass = {instance_key("walk", fn): ops
            for fn, ops in sass_counts("walk").items()}
    if not sass:
        raise AssertionError("walk: no SASS (cuobjdump missing?)")
    for key, ops in sorted(sass.items()):
        dtype, variant, score, det, seg = key
        want = PLANE_VECTOR_LOADS.get((variant, dtype))
        if want is None:
            continue
        packed = sass[(dtype, "packed", score, det, seg)]
        vec, narrow = ops["LDG.128"], ops["LDG"] - ops["LDG.128"]
        p_narrow = packed["LDG"] - packed["LDG.128"]
        print(f"# W0 {variant}<{dtype}> scoring {'on' if score else 'off'}"
              f"{', deterministic commit' if det else ''}"
              f"{', segmented commit' if seg else ''}: global loads "
              f"{vec} x 128-bit, {narrow} narrower (packed: "
              f"{packed['LDG.128']} x 128-bit, {p_narrow} narrower)")
        if vec < want or narrow > p_narrow:
            raise AssertionError(
                f"W0 {variant}<{dtype}> {key[2:]}: {vec} 128-bit loads "
                f"(at least {want} wanted), {narrow} narrower loads "
                f"against the packed instantiation's {p_narrow}: a plane "
                "is read in pieces")


def score_lanes(runtime, n: int, seed: int):
    """The resolved (bin_off, fac) of ``score_attrs(seed, n)`` on the
    card, and the mask of particles that score (not dropped)."""
    import torch

    e, t = (torch.as_tensor(a, dtype=runtime.dtype, device=runtime.device)
            for a in score_attrs(seed, n))
    sbin, sfac = runtime.resolve(e, t, n)
    return sbin, sfac, sbin < runtime.bank_size


def check_bank(what: str, got, want, kinds) -> float:
    """Every track lane at rtol 1e-4 of its own value (the lanes sum
    positive terms, so only the order of the sum differs; the atol is the
    dtype's smallest normal), count lanes equal and whole; returns the
    track lanes' max abs difference."""
    import torch

    S = len(kinds)
    err = 0.0
    for k, kind in enumerate(kinds):
        g, w = got[k::S], want[k::S]
        if kind == "count":
            check_equal(f"{what} lane {k} (count)", g, w)
            if not torch.equal(g, torch.round(g)):
                raise AssertionError(f"{what}: count lane {k} not whole")
            continue
        diff = (g.double() - w.double()).abs()
        limit = FLUX_RTOL * w.double().abs() + torch.finfo(w.dtype).tiny
        bad = diff > limit
        if bool(bad.any()):
            i = int(bad.nonzero()[0])
            raise AssertionError(
                f"{what} lane {k}: {int(bad.sum())} lanes differ by more "
                f"than rtol {FLUX_RTOL}, first at {i}: {float(g[i])!r} vs "
                f"{float(w[i])!r}")
        err = max(err, max_abs(g, w))
    return err


def bank_bytes(bank, k: int) -> int:
    """The bank's bytes a scoring walk must move: each lane it touched
    read and written once. A lane is touched iff it holds a non-zero sum
    (every value added is positive), so this counts the plain run's
    non-zero lanes."""
    return int((bank != 0).sum()) * 2 * k


def in_turns(arms: dict, timer, passes: int = SCORE_PASSES) -> dict:
    """``passes`` times of each arm, in turns (a, b, c, c, b, a, ...)."""
    out = {k: [] for k in arms}
    for p in range(passes):
        for k in list(arms)[::1 if p % 2 == 0 else -1]:
            out[k].append(timer(arms[k]))
    return out


def zero_bank(size: int, like, offset: int = 0):
    """A zeroed bank of ``size`` lanes that starts ``offset`` lanes into
    its allocation (offset 1: 4 bytes past the allocator's alignment in
    float32, so the rows' places in their 16-byte quads shift)."""
    import torch

    return torch.zeros((size + offset,), dtype=like.dtype,
                       device=like.device)[offset:]


def phase_w0_scoring(mesh, pts, label: str, two_tier: bool,
                     n: int = N, spec=None, edge: bool = False,
                     inputs=None) -> dict:
    """W0's scoring instantiation at the main path's shapes with the
    stride-96 spec against ``walk_plain(scoring=)``: ids, masks, iters,
    x and s bitwise and equal to the scoring-off kernel's; flux and the
    track lanes at rtol 1e-4; the event lanes equal and whole. Then the
    scoring-off and scoring-on times in turns, and (packed float32 tier)
    the count of a warp's particles that share lanes at a step.

    ``edge`` (phase 6c, the scoring commit's edge cases): ``spec`` in
    place of the stride-96 one; EDGE_LEAD particles start at the last
    element's centroid in its last bin, so the plain run must touch the
    bank's last lane (the row-boundary split and W0's DROP limit); in
    float32 the kernel runs again on a bank one lane off the
    allocation's alignment, held to the same plain run; no times.
    ``inputs``: ``w0_inputs``' result to reuse (the edge cases override
    the same leading particles each time)."""
    import torch

    from pumiumtally_tpu_torch.experiments.score_collisions import (
        warp_collisions,
    )
    from pumiumtally_tpu_torch.ops.walk import walk, walk_plain
    from pumiumtally_tpu_torch.scoring import ScoringRuntime

    name = f"W0{' two-tier' if two_tier else ''} scoring{label}"
    args, kw = inputs or w0_inputs(mesh, pts, two_tier, n)
    m, x = args[:2]
    spec = spec or score_spec()
    rt = ScoringRuntime(spec, m.nelems, x.dtype, x.device)
    sbin, sfac, scoring = score_lanes(rt, n, 5)
    S = spec.n_scores
    if edge:
        last = m.nelems - 1
        x[:EDGE_LEAD] = m.coords[m.tet2vert[last].long()].mean(dim=0)
        args[2][:EDGE_LEAD] = last
        sbin[:EDGE_LEAD] = (spec.n_bins - 1) * S
        scoring = sbin < rt.bank_size

    def zeros(offset=0):
        return (torch.zeros((m.nelems,), dtype=x.dtype, device=x.device),
                zero_bank(rt.bank_size, x, offset))

    def run(fn, score=True, bufs=None):
        flux, bank = bufs or zeros()
        sc = (spec.kinds, bank, sbin, sfac) if score else None
        return fn(*args, flux, **kw, scoring=sc), bank

    (rk, bank_k), (ro, _), (rp, bank_p) = (run(walk), run(walk, False),
                                           run(walk_plain))
    runs = [("", rk, bank_k)]
    if edge and x.dtype == torch.float32:
        runs.append((" (bank off alignment)",
                     *run(walk, bufs=zeros(offset=1))))
    sync()
    err = check_flux(f"{name} (scoring off)", rk.flux, ro.flux)
    for arm, r, bank in runs:
        for f in ("elem", "done", "exited", "iters", "x", "s"):
            check_equal(f"{name}{arm} {f}", getattr(r, f), getattr(rp, f))
            check_equal(f"{name}{arm} {f} (scoring off)", getattr(r, f),
                        getattr(ro, f))
        err = max(err, check_flux(f"{name}{arm}", r.flux, rp.flux),
                  check_bank(f"{name}{arm}", bank, bank_p, spec.kinds))
    dropped = int((~scoring).sum())
    if not 0 < dropped < n // 20 or not bool(bank_k[S - 1::S].sum() > 0):
        raise AssertionError(f"{name}: {dropped} of {n} dropped")
    if edge:
        if not bool(bank_p[-1] != 0):
            raise AssertionError(f"{name}: the bank's last lane untouched")
        print(f"# {name}: {S} scores, stride {rt.stride}, {len(runs)} "
              f"bank alignment(s); ids/x/s bitwise and equal to scoring "
              f"off; lanes max abs diff {err:.3e}, count lanes exact; the "
              f"bank's last lane {float(bank_p[-1])!r} (plain) and "
              f"{float(bank_k[-1])!r}; {dropped} of {n} dropped")
        return {}
    # Timed calls add into standing flux and bank buffers: zeroing them
    # is not the kernel's work. CUDA events, as W0's other times: the
    # profiler drops some of the lattice walks' activities.
    bufs = zeros()
    turns = in_turns({"off": lambda: run(walk, False, bufs),
                      "on": lambda: run(walk, True, bufs)}, cuda_ms)
    t_off, t_on = turns["off"], turns["on"]
    plain_ms = wall_ms(lambda: run(walk_plain))
    step = (twotier_step(m.walk_table_lo, m.walk_table_hi) if two_tier
            else packed_step(m.walk_table))
    crossings = count_crossings(step, x, args[2], args[3],
                                torch.ones_like(scoring), 0, kw["tol"])
    scored = count_crossings(step, x, args[2], args[3], scoring, 0,
                             kw["tol"])
    k = x.element_size()
    S = spec.n_scores
    row_bytes = 32 + 4 * 5 * k if two_tier else 20 * k
    # W0's bytes, then each bank lane the run touched read and written
    # once and each particle's bin offset and factors read once.
    nbytes = (n * (11 * k + 11) + m.nelems * (row_bytes + 2 * k)
              + bank_bytes(bank_p, k) + n * (4 + S * k))
    flops = (FLOPS_PER_CROSSING_TWO_TIER if two_tier
             else FLOPS_PER_CROSSING) + S
    bound = bound_entry(nbytes, crossings, flops,
                        F32_FLOPS if k == 4 else F64_FLOPS)
    ms = float(np.median(t_on))
    if not two_tier and k == 4:
        hits = warp_collisions(step, x, args[2], args[3], sbin, scoring,
                               m.nelems, rt.stride, kw["tol"])
        print(f"# {name}: warp collisions {json.dumps(hits)}")
    print(f"# {name}: scoring on {', '.join(f'{v:.4f}' for v in t_on)} ms, "
          f"off {', '.join(f'{v:.4f}' for v in t_off)} ms (CUDA events, in "
          f"turns); plain {plain_ms:.3f} ms; {crossings} crossings, "
          f"{scored} by scoring particles, {dropped} of {n} particles "
          f"dropped; bank "
          f"{rt.bank_size} lanes; ids/x/s bitwise and equal to scoring "
          f"off; lanes max abs diff {err:.3e}, events exact; bound {bound}")
    return {"name": f"W0 walk ({'two-tier, ' if two_tier else ''}scoring)",
            "route": "cuda",
            "source": "pumiumtally_tpu_torch/csrc/walk.cu",
            "replaces": ("pumiumtally_tpu/ops/walk.py:425" if two_tier
                         else "pumiumtally_tpu/ops/walk.py:177"),
            "max_abs_err": err, "ms": ms, "off_ms": float(np.median(t_off)),
            "plain_ms": plain_ms, **bound, "library_ms": None}


def w2_score_state(mesh, pts, bound, spec) -> tuple:
    """The first move's W2 round-1 input with scoring, localised by
    ``PartitionedPumiTally`` (``walk_vmem_max_elems=bound``, the two-tier
    tables): (engine, its ScoringRuntime, the block tables, the kernel's
    keywords, the slot state with ``sbin``/``sfac`` rows from
    ``score_lanes``)."""
    import torch

    from pumiumtally_tpu_torch import PartitionedPumiTally, TallyConfig

    t = PartitionedPumiTally(
        mesh, N, TallyConfig(capacity_factor=CAPACITY_FACTOR,
                             walk_vmem_max_elems=bound, scoring=spec,
                             check_found_all=False, walk_kernel="pallas",
                             **BF16))
    t.CopyInitialPosition(flat(pts[0]))
    eng, rt = t.engine, t._scoring
    tables = (eng.part.table, eng.part.table_hi)
    kw = dict(tally=True, tol=eng.tol, max_iters=eng.max_iters,
              blocks=eng.nparts)
    sbin_n, sfac_n, _ = score_lanes(rt, N, 6)
    st = dict(eng.state)
    st["fly"] = st["alive"].to(torch.int8)
    st["w"] = st["fly"].to(torch.float32)
    st["done"] = ~st["alive"]
    st["exited"] = torch.zeros_like(st["done"])
    st["dest"] = eng._by_pid(torch.as_tensor(pts[1], dtype=torch.float32,
                                             device=t.device), 0.0)
    st["sbin"] = eng._by_pid(sbin_n, 0)
    st["sfac"] = eng._by_pid(sfac_n, 0.0)
    return eng, rt, tables, kw, st


def phase_w2_scoring(mesh, pts, bound, shared: bool, spec=None,
                     edge: bool = False) -> dict:
    """W2's scoring instantiation against ``pallas_walk_local_plain(
    scoring=)`` on every tallied round of the first move (each round's
    input migrated, ``sbin``/``sfac`` rows with it, from the kernel's
    previous output), in the regime ``shared`` asks for: ids, masks,
    pending, iters and x bitwise and equal to the scoring-off kernel's;
    flux and track lanes at rtol 1e-4, events exact. Rounds 1 and 2
    timed scoring off and on, in turns.

    ``edge`` (phase 6c): ``spec`` in place of the stride-96 one;
    EDGE_LEAD active slots of the last block restart at the centroid of
    its last element in the last bin, so the plain run must touch that
    row's last lane (the bank's last lane where the block is full); the
    kernel also runs on a bank one lane off the allocation's alignment;
    the first EDGE_ROUNDS rounds; no times."""
    import torch

    from pumiumtally_tpu_torch.experiments.block_rounds import round_bytes
    from pumiumtally_tpu_torch.ops.pallas_walk import (
        pallas_walk_local,
        pallas_walk_local_plain,
        w2_uses_shared,
    )

    spec = spec or score_spec()
    eng, rt, tables, kw, st = w2_score_state(mesh, pts, bound, spec)
    L, dev = eng.part.L, st["x"].device
    label = f"W2 scoring ({'shared' if shared else 'global'})"
    if w2_uses_shared(L, torch.float32) != shared:
        raise AssertionError(f"{label}: blocks of {L} elements")
    nscores, stride = spec.n_scores, rt.stride
    if edge:
        b, cap_b = eng.nparts - 1, eng.cap_per_block
        real = (eng.part.orig_of_glid[b * L:(b + 1) * L] >= 0).nonzero()
        glid = b * L + int(real.max())
        orig = int(eng.part.orig_of_glid[glid])
        slots = b * cap_b + (~st["done"][b * cap_b:(b + 1) * cap_b]
                             ).nonzero()[:EDGE_LEAD, 0]
        for key in ("x", "lelem", "sbin"):
            st[key] = st[key].clone()
        st["x"][slots] = mesh.coords[mesh.tet2vert[orig].long()].mean(
            dim=0).to(dev)
        st["lelem"][slots] = glid - b * L
        st["sbin"][slots] = (spec.n_bins - 1) * nscores
        last_lane = (glid + 1) * stride - 1
        touched = False

    def run(fn, st, score=True, bufs=None):
        flux, bank = bufs or (torch.zeros_like(eng.flux_padded),
                              torch.zeros_like(eng.score_padded))
        sc = (spec.kinds, bank, st["sbin"], st["sfac"]) if score else None
        return fn(*tables, st["x"], st["lelem"], st["dest"], st["fly"],
                  st["w"], st["done"], st["exited"], flux, **kw,
                  scoring=sc), bank

    err, timed = 0.0, []
    S = st["x"].shape[0]
    base = (torch.arange(S, device=dev) // eng.cap_per_block) * L
    for r in range(1, eng.max_rounds + 1):
        (rk, bank_k), (ro, _), (rp, bank_p) = (
            run(pallas_walk_local, st), run(pallas_walk_local, st, False),
            run(pallas_walk_local_plain, st))
        runs = [("", rk, bank_k)]
        if edge:
            off = (torch.zeros_like(eng.flux_padded),
                   zero_bank(eng.score_padded.numel(), eng.score_padded, 1))
            runs.append((" (bank off alignment)",
                         *run(pallas_walk_local, st, bufs=off)))
        sync()
        for arm, out, bank in runs:
            for i, f in ((0, "x"), (1, "lelem"), (2, "done"), (3, "exited"),
                         (4, "pending"), (6, "iters")):
                check_equal(f"{label}{arm} round {r} {f}", out[i], rp[i])
                check_equal(f"{label}{arm} round {r} {f} (scoring off)",
                            out[i], ro[i])
            err = max(err, check_flux(f"{label}{arm} round {r}", out[5],
                                      rp[5]),
                      check_bank(f"{label}{arm} round {r}", bank, bank_p,
                                 spec.kinds))
        if edge:
            touched = touched or bool(bank_p[last_lane] != 0)
            if r == EDGE_ROUNDS:
                break
        elif r <= 2:
            x0 = st["x"]
            crossings = count_crossings(
                twotier_step(*tables), x0, st["lelem"], x0 + (st["dest"] - x0),
                ~st["done"], base, eng.tol)
            scoring = ~st["done"] & (st["sbin"] < rt.bank_size)
            scored = count_crossings(
                twotier_step(*tables), x0, st["lelem"], x0 + (st["dest"] - x0),
                scoring, base, eng.tol)
            nbytes = (round_bytes(st["done"], st["exited"], eng.nparts, L,
                                  32 + 4 * 20, 4)
                      + bank_bytes(bank_p, 4)
                      + int((~st["done"]).sum()) * 16)
            b = bound_entry(nbytes, crossings, FLOPS_PER_CROSSING_TWO_TIER + 3)
            us = functools.partial(device_us, reps=5,
                                   name="twotier_block_walk_kernel")
            # Into standing buffers, as W0's times.
            bufs = (torch.zeros_like(eng.flux_padded),
                    torch.zeros_like(eng.score_padded))
            turns = in_turns(
                {"off": lambda: run(pallas_walk_local, st, False, bufs),
                 "on": lambda: run(pallas_walk_local, st, True, bufs)},
                lambda fn: us(fn) / 1e3)
            t_off, t_on = turns["off"], turns["on"]
            plain_ms = wall_ms(lambda: run(pallas_walk_local_plain, st))
            timed.append(dict(ms=float(np.median(t_on)),
                              off_ms=float(np.median(t_off)),
                              plain_ms=plain_ms, **b))
            print(f"# {label} round {r}: {eng.nparts} blocks of <= {L}, "
                  f"{int((~st['done']).sum())} active; scoring on "
                  f"{', '.join(f'{v:.4f}' for v in t_on)} ms, off "
                  f"{', '.join(f'{v:.4f}' for v in t_off)} ms (profiler, in "
                  f"turns); plain {plain_ms:.3f} ms; {crossings} crossings, "
                  f"{scored} scoring; bound {b}")
        if not bool((rk[4] >= 0).any()):
            break
        st = eng._migrate(dict(st, x=rk[0], lelem=rk[1], done=rk[2],
                               exited=rk[3], pending=rk[4]))
    if edge:
        if not touched:
            raise AssertionError(f"{label}: lane {last_lane}, the last of "
                                 f"element {glid}'s row, untouched")
        print(f"# {label} edge cases: {nscores} scores, stride {stride}, "
              f"{r} rounds, both bank alignments bitwise to the plain "
              f"version and to scoring off; lanes max abs diff {err:.3e}, "
              f"count lanes exact; the last block's last element's last "
              f"lane {last_lane} of {eng.score_padded.numel()} touched")
        return {}
    print(f"# {label}: {r} rounds, each bitwise to the plain version and to "
          f"scoring off; lanes max abs diff {err:.3e}, events exact")
    return {"name": "W2 twotier_block_walk (scoring)", "route": "cuda",
            "source": "pumiumtally_tpu_torch/csrc/twotier_block_walk.cu",
            "replaces": "pumiumtally_tpu/ops/pallas_walk.py:381",
            "max_abs_err": err, **timed[0], "library_ms": None}


def score_batches(facade, mesh, config, trajs, n: int, label: str,
                  continue_moves: int, profile: bool = False) -> tuple:
    """The scoring slice's main path on one facade: SCORE_BATCHES batches,
    each CopyInitialPosition, a two-phase move and ``continue_moves``
    continue moves on ``trajs(b)`` (the batch's points, an iterator), all
    with energies and times from ``score_attrs`` (every energy in range),
    then ``finalize``. The launch counts are reset just before and read
    just after. Held: conservation at rtol 1e-6; the flux score summed
    over bins equal to the flux lane at rtol 1e-4; the event lanes whole;
    ``rel_err`` finite where flux > 0; WriteTallyResults writes the score
    and statistics arrays. ``profile``: then one profiled continue move
    along the last batch's trajectory. Returns (launch counts, the
    facade)."""
    import torch

    from pumiumtally_tpu_torch import kernels
    from pumiumtally_tpu_torch.io.vtk import read_vtk_cell_scalars

    kernels.reset_launch_counts()
    t = facade(mesh, n, config=config)
    expect, move_ms = 0.0, []
    for b in range(SCORE_BATCHES):
        energy, tm = score_attrs(20 + b, n, out=0.0)
        kw = dict(energy=energy, time=tm)
        traj = trajs(b)
        prev = next(traj)
        t.CopyInitialPosition(flat(prev))
        for m in range(1 + continue_moves):
            cur = next(traj)
            expect += float(np.linalg.norm(cur - prev, axis=1).sum())
            if m == 0:
                t.MoveToNextLocation(flat(prev), flat(cur),
                                     np.ones(n, np.int8), np.ones(n), **kw)
            else:
                move_ms.append(wall_ms(lambda: t.MoveToNextLocation(
                    None, flat(cur), **kw)))
            prev = cur
    st = t.finalize()
    sync()
    counts = dict(kernels.launch_counts)
    rel = check_conservation(label, t.flux, expect)
    arr = t.score_array()
    err = check_flux(f"{label} flux score over bins",
                     arr[:, :, 0].sum(dim=1), t.flux)
    events = arr[:, :, 2]
    if not torch.equal(events, torch.round(events)) or not bool(
            events.sum() > 0):
        raise AssertionError(f"{label}: event lanes not whole or empty")
    flux = t.flux
    rel_err = st.rel_err
    if st.num_batches != SCORE_BATCHES or not bool(
            torch.isfinite(rel_err[flux > 0]).all()):
        raise AssertionError(f"{label}: {st.num_batches} batches, rel_err "
                             "not finite where flux > 0")
    score_st = t.score_statistics()
    with tempfile.TemporaryDirectory() as d:
        out = f"{d}/scored.vtk"
        t.WriteTallyResults(out)
        for name in ("flux_bin0", "heating_bin31", "events_bin17",
                     "flux_mean", "rel_err"):
            if read_vtk_cell_scalars(out, name).shape[0] != t.mesh.nelems:
                raise AssertionError(f"{label}: {name} not written")
    print(f"# scoring {label}: {SCORE_BATCHES} batches of {n} particles, "
          f"conservation rel err {rel:.3e}; flux score over bins vs flux "
          f"max abs diff {err:.3e}; events {float(events.sum()):.0f}, whole; "
          f"rel_err finite where flux > 0 (median "
          f"{float(rel_err[flux > 0].median()):.3e}); score statistics "
          f"{score_st.num_batches} batches; VTK score and statistics arrays "
          f"written; continue move ms with scoring "
          f"{', '.join(f'{v:.2f}' for v in move_ms) or 'none'}; launches "
          f"{counts}")
    if profile:
        # One more continue move along the last batch's trajectory,
        # after the checks (it adds to the flux).
        profile_move(t, next(traj), kw)
    return counts, t


def phase_scoring_sync(mesh, pts) -> None:
    """An unfenced, unchecked continue move with scoring (energy and time
    staged, bins resolved on the device, W0's scoring lanes) under
    ``torch.cuda.set_sync_debug_mode("error")``, behind ~50 ms of queued
    device work: it must return while that still runs."""
    import torch

    from pumiumtally_tpu_torch import PumiTally, TallyConfig

    t = PumiTally(mesh, N, TallyConfig(
        check_found_all=False, fenced_timing=False, scoring=score_spec(),
        batch_stats=True))
    energy, tm = score_attrs(30, N)
    t.CopyInitialPosition(flat(pts[0]))
    t.MoveToNextLocation(flat(pts[0]), flat(pts[1]), np.ones(N, np.int8),
                         np.ones(N), energy=energy, time=tm)
    t.MoveToNextLocation(None, flat(pts[2]), energy=energy, time=tm)
    sync()
    torch.cuda._sleep(SLEEP_CYCLES)
    ahead = torch.cuda.Event()
    ahead.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        t.MoveToNextLocation(None, flat(pts[3]), energy=energy, time=tm)
        host_ms = (time.perf_counter() - t0) * 1e3
        busy = not ahead.query()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not busy:
        raise AssertionError("scoring: the unfenced continue move returned "
                             "after the device work queued ahead had ended")
    print(f"# scoring: an unfenced, unchecked continue move with scoring "
          f"made no host synchronization (sync debug mode 'error') and "
          f"returned after {host_ms:.3f} ms with the ~50 ms queued ahead "
          "still running")


def phase_scoring_facades(mesh, pts, lat_path: str, lat_box, card: str):
    """The four facades with the stride-96 spec and ``batch_stats=True``
    (``score_batches``): ``PumiTally`` on both tiers on the box and the
    lattice (from its path), ``PartitionedPumiTally`` on W2, then
    ``StreamingTally`` at 10M (float32) and ``StreamingPartitionedTally``
    (W2, at 10M, one two-phase move a batch); one profiled continue move
    of the box ``PumiTally`` with scoring. Returns each run's launch
    counts."""
    from pumiumtally_tpu_torch import (
        PartitionedPumiTally,
        PumiTally,
        StreamingPartitionedTally,
        StreamingTally,
        TallyConfig,
    )
    from pumiumtally_tpu_torch.experiments.block_rounds import (
        make_trajectory,
    )

    def cfg(**kw):
        return TallyConfig(scoring=score_spec(), batch_stats=True, **kw)

    def box_trajs(b):
        return iter(pts if b == 0 else make_trajectory(
            np.random.default_rng(40 + b), N, CONTINUE_MOVES + 2))

    def lat_trajs(b):
        return iter(make_trajectory(np.random.default_rng(50 + b), N,
                                    CONTINUE_MOVES + 2, box=lat_box))

    def stream_trajs(b):
        return trajectory_moves(60 + b, STREAM_N)

    w2 = dict(walk_kernel="pallas", capacity_factor=CAPACITY_FACTOR,
              walk_vmem_max_elems=VMEM_BOUND, **BF16)
    chunked = dict(chunk_size=STREAM_CHUNK)
    runs = {
        "score_mono": (PumiTally, mesh, cfg(), box_trajs, N,
                       CONTINUE_MOVES),
        "score_mono_bf16": (PumiTally, mesh, cfg(**BF16), box_trajs, N,
                            CONTINUE_MOVES),
        "score_part": (PartitionedPumiTally, mesh, cfg(**w2), box_trajs, N,
                       CONTINUE_MOVES),
        # The gather block walk W4's scoring: the default config (float32
        # tables, one block) and the bf16 tables with the vmem knobs.
        "score_part_gather": (PartitionedPumiTally, mesh, cfg(),
                              box_trajs, N, CONTINUE_MOVES),
        "score_part_gather_bf16": (
            PartitionedPumiTally, mesh,
            cfg(capacity_factor=CAPACITY_FACTOR,
                walk_vmem_max_elems=VMEM_BOUND, **BF16),
            box_trajs, N, CONTINUE_MOVES),
        "score_lat": (PumiTally, lat_path, cfg(), lat_trajs, N,
                      CONTINUE_MOVES),
        "score_lat_bf16": (PumiTally, lat_path, cfg(**BF16), lat_trajs, N,
                           CONTINUE_MOVES),
        "score_stream": (functools.partial(StreamingTally, **chunked), mesh,
                         cfg(), stream_trajs, STREAM_N,
                         STREAM_CONTINUE_MOVES),
        "score_stream_part": (
            functools.partial(StreamingPartitionedTally, **chunked), mesh,
            cfg(**w2), stream_trajs, STREAM_N, 0),
    }
    counts = {}
    for key, (facade, m, config, trajs, n, moves) in runs.items():
        t0 = time.perf_counter()
        counts[key], t = score_batches(
            facade, m, config, trajs, n, key, moves,
            profile=key in ("score_mono", "score_mono_bf16", "score_part",
                            "score_part_gather"))
        del t
        print(f"# scoring {key}: {time.perf_counter() - t0:.1f} s on {card}")
    return counts


# The unpacked mesh layout (W0's unpacked instantiation), the straggler
# ladder and intersection_points.
# The mesh past the float lanes' exact ids: box_arrays(1, 1, 1, 142, 142,
# 142), 17,179,728 tets in float32.
LARGE_DIV = 142
LARGE_TETS = 6 * LARGE_DIV ** 3
LARGE_CONTINUE_MOVES = 2
LARGE_PASSES = 4  # phase 12b's timed passes of the continue walk
# The sentinel's cells: max_iters=2 truncates most particles of a move.
LADDER_ITERS = 2
LADDER_STREAM_CHUNK = 100_000
LADDER_QUARANTINE_N = 10_000  # the starved ladder's quarantine run
LADDER_PASSES = 4  # audited and sentinel-off moves timed in turns


def unpacked_layout(mesh, layout: str):
    """The mesh a cell of ``layout`` walks: "row16" the unpacked layout
    (``with_unpacked_planes``: the packed table's own plane values, what
    ``TetMesh.from_arrays(force_unpacked=True)`` stores), "row20" a
    two-tier mesh's refinement tier in place (``with_plane_views``), else
    the mesh itself."""
    if layout == "row16":
        return mesh.with_unpacked_planes()
    return mesh.with_plane_views() if layout == "row20" else mesh


def unpacked_row_bytes(k: int, row: int = 16) -> int:
    """Bytes a crossing of the unpacked walk reads for one tet: ROW16's
    12 normal components and 4 offsets in the working dtype and 4 int32
    ids (80 B in float32, as the packed row), or ROW20's block of four
    refinement rows (ids in its adj lanes)."""
    return 16 * k + 16 if row == 16 else 20 * k


def phase_w0_unpacked(mesh, pts, label: str = "", n: int = N,
                      views: bool = False) -> list:
    """W0's unpacked entries on ``mesh`` in the forced unpacked layout
    (ROW16) against ``walk_plain (ids, masks,
    iters, x and s bitwise, flux at rtol 1e-4, the kernel's walked count
    == n), flux conserved at rtol 1e-6 against the analytic track
    length, and against the packed W0 on the same inputs: x and s
    bitwise, ids equal. The same for the scoring entry with the
    stride-96 spec (lanes as phase 6b). Then both entries timed in turns
    with the packed W0 (four passes, CUDA events, into standing
    buffers), beside the bytes bound. ``views``: the other caller, a
    two-tier mesh walked by ``walk(..., table_dtype="float32")`` (the
    sentinel's rung 2): the planes read in place from ``walk_table_hi``
    (ROW20), held to ``walk_plain`` on
    ``with_plane_views()`` and to the packed W0 on
    ``with_packed_table()`` in the same way, the launches counted under
    ``walk_unpacked`` / ``walk_unpacked_scored``. Returns the two kernel
    entries."""
    import torch

    from pumiumtally_tpu_torch import kernels
    from pumiumtally_tpu_torch.ops.walk import (
        check_plane_layout,
        walk,
        walk_plain,
    )
    from pumiumtally_tpu_torch.scoring import ScoringRuntime

    args, kw = w0_inputs(mesh, pts, views, n)
    m, x = args[:2]
    um = unpacked_layout(m, "row20" if views else "row16")
    row = check_plane_layout(um, x.device, x.dtype)
    if row != (20 if views else 16):
        raise AssertionError(f"W0 unpacked{label}: layout ROW{row}")
    uargs = (um, *args[1:])
    # The kernel's call: the two-tier mesh asked for the float32 tier,
    # or the unpacked mesh itself.
    kargs, tier = (args, "float32") if views else (uargs, None)
    if views:
        args = (m.with_packed_table(), *args[1:])  # the packed W0's input
    spec = score_spec()
    rt = ScoringRuntime(spec, m.nelems, x.dtype, x.device)
    sbin, sfac, scoring = score_lanes(rt, n, 5)

    def zeros():
        return (torch.zeros((m.nelems,), dtype=x.dtype, device=x.device),
                torch.zeros((rt.bank_size,), dtype=x.dtype,
                            device=x.device))

    def run(fn, a, score=False, bufs=None, **extra):
        flux, bank = bufs or zeros()
        sc = (spec.kinds, bank, sbin, sfac) if score else None
        return fn(*a, flux, **kw, scoring=sc, **extra), bank

    name = f"W0 unpacked{label}"
    counts = torch.zeros((1,), dtype=torch.int32, device=x.device)
    before = dict(kernels.launch_counts)
    ru, _ = run(walk, kargs, counts=counts, table_dtype=tier)
    su, bank_u = run(walk, kargs, True, table_dtype=tier)
    launched = {e: kernels.launch_counts[e] - before[e]
                for e in ("walk_unpacked", "walk_unpacked_scored")}
    if launched != {"walk_unpacked": 1, "walk_unpacked_scored": 1}:
        raise AssertionError(f"{name}: launches {launched}")
    (rp, _), (rk, _) = run(walk_plain, uargs), run(walk, args)
    (sp, bank_p), (sk, _) = run(walk_plain, uargs, True), run(walk, args,
                                                              True)
    sync()
    for f in ("elem", "done", "exited", "iters", "x", "s"):
        check_equal(f"{name} {f}", getattr(ru, f), getattr(rp, f))
        check_equal(f"{name} scoring {f}", getattr(su, f), getattr(sp, f))
        check_equal(f"{name} {f} (packed W0)", getattr(ru, f),
                    getattr(rk, f))
        check_equal(f"{name} scoring {f} (packed W0)", getattr(su, f),
                    getattr(sk, f))
    err = check_flux(name, ru.flux, rp.flux)
    err_s = max(check_flux(f"{name} scoring", su.flux, sp.flux),
                check_bank(f"{name} scoring", bank_u, bank_p, spec.kinds))
    walked = int(counts[0])
    if walked != n:
        raise AssertionError(f"{name}: the kernel walked {walked} "
                             f"particles, not {n}")
    expect = float((args[5].double()
                    * (ru.x.double() - x.double()).norm(dim=1)).sum())
    rel = check_conservation(name, ru.flux, expect)
    bufs = zeros()
    turns = in_turns({
        "packed": lambda: run(walk, args, bufs=bufs),
        "unpacked": lambda: run(walk, kargs, bufs=bufs, table_dtype=tier),
        "unpacked_scored": lambda: run(walk, kargs, True, bufs=bufs,
                                       table_dtype=tier),
    }, cuda_ms, passes=4)
    plain_ms = wall_ms(lambda: run(walk_plain, uargs))
    plain_s_ms = wall_ms(lambda: run(walk_plain, uargs, True))
    crossings = count_crossings(packed_step(args[0].walk_table), x, args[2],
                                args[3], torch.ones_like(scoring), 0,
                                kw["tol"])
    k = x.element_size()
    nbytes = n * (11 * k + 11) + m.nelems * (unpacked_row_bytes(k, row)
                                             + 2 * k)
    flops = F32_FLOPS if k == 4 else F64_FLOPS
    bound = bound_entry(nbytes, crossings, FLOPS_PER_CROSSING, flops)
    bound_s = bound_entry(nbytes + bank_bytes(bank_p, k)
                          + n * (4 + spec.n_scores * k), crossings,
                          FLOPS_PER_CROSSING + spec.n_scores, flops)
    med = {a: float(np.median(v)) for a, v in turns.items()}
    print(f"# {name}: {n} particles on {m.nelems} tets, layout "
          f"ROW{row}; in turns (CUDA "
          f"events, ms): " + "; ".join(
              f"{a} {', '.join(f'{v:.4f}' for v in t)}"
              for a, t in turns.items())
          + f"; plain {plain_ms:.3f} ms (scoring {plain_s_ms:.3f}); "
          f"{crossings} crossings; unpacked / packed "
          f"{med['unpacked'] / med['packed']:.3f}; walked {walked} of {n}; "
          f"x, s bitwise vs plain and vs packed W0, ids equal; flux max abs "
          f"diff {err:.3e}, conservation rel err {rel:.3e}; lanes max abs "
          f"diff {err_s:.3e}; bound {bound}, scoring {bound_s}")
    base = {"route": "cuda", "source": "pumiumtally_tpu_torch/csrc/walk.cu",
            "library_ms": None}
    return [
        {**base, "name": "W0 walk (unpacked)", "entry": "walk_unpacked",
         "replaces": "pumiumtally_tpu/ops/walk.py:279",
         "max_abs_err": err, "ms": med["unpacked"],
         "packed_ms": med["packed"], "plain_ms": plain_ms, **bound},
        {**base, "name": "W0 walk (unpacked, scoring)",
         "entry": "walk_unpacked_scored",
         "replaces": "pumiumtally_tpu/ops/walk.py:279",
         "max_abs_err": err_s, "ms": med["unpacked_scored"],
         "plain_ms": plain_s_ms, **bound_s},
    ]


def phase_unpacked_main_path(mesh, pts, card: str) -> dict:
    """``PumiTally`` on the box in the forced unpacked layout through the
    main path, with the stride-96 spec (energies in range): localization
    and phase A on ``walk_unpacked``, phase B on ``walk_unpacked_scored``;
    conservation at rtol 1e-6; launch counts reset before and read
    after."""
    from pumiumtally_tpu_torch import PumiTally, TallyConfig, kernels

    e, tm = score_attrs(11, N, out=0.0)
    kernels.reset_launch_counts()
    t = PumiTally(mesh.with_unpacked_planes(), N,
                  TallyConfig(scoring=score_spec()))
    t.CopyInitialPosition(flat(pts[0]))
    t.MoveToNextLocation(flat(pts[0]), flat(pts[1]), np.ones(N, np.int8),
                         np.ones(N), energy=e, time=tm)
    ms = wall_ms(lambda: t.MoveToNextLocation(None, flat(pts[2]), energy=e,
                                              time=tm))
    counts = dict(kernels.launch_counts)
    expect = sum(float(np.linalg.norm(pts[m] - pts[m - 1], axis=1).sum())
                 for m in (1, 2))
    rel = check_conservation("unpacked PumiTally", t.flux, expect)
    print(f"# main path PumiTally (unpacked layout, scoring) on {card}: "
          f"continue move {ms:.3f} ms; conservation rel err {rel:.3e}; "
          f"launches {counts}")
    return counts


def phase_large_mesh(card: str) -> dict:
    """The mesh past the float lanes' exact ids: ``box_arrays(1, 1, 1,
    142, 142, 142)`` in float32 builds in the unpacked layout with no
    flag. ``PumiTally`` at 500,000 particles: localization by walk, a
    two-phase move and two continue moves on bench.py's trajectory,
    conservation at rtol 1e-6 after each move, one continue move checked
    against ``walk_plain`` on the card (ids, x, s bitwise, flux rtol
    1e-4), then its kernel timed (``large_walk_times``: CUDA events,
    LARGE_PASSES passes, beside its bound). Prints the set-up seconds,
    the device table bytes, the moves' ms and the host's peak memory."""
    import resource

    import torch

    from pumiumtally_tpu_torch import PumiTally, TallyConfig, kernels
    from pumiumtally_tpu_torch.experiments.block_rounds import (
        make_trajectory,
    )
    from pumiumtally_tpu_torch.mesh.box import box_arrays
    from pumiumtally_tpu_torch.mesh.tetmesh import TetMesh
    from pumiumtally_tpu_torch.ops.walk import walk, walk_plain

    t0 = time.perf_counter()
    coords, tets = box_arrays(1, 1, 1, LARGE_DIV, LARGE_DIV, LARGE_DIV)
    mesh = TetMesh.from_arrays(coords, tets, dtype=torch.float32)
    del coords, tets
    build_s = time.perf_counter() - t0
    if not mesh.unpacked or mesh.nelems != LARGE_TETS:
        raise AssertionError(f"large mesh: {mesh.nelems} tets, unpacked "
                             f"{mesh.unpacked}")
    pts = make_trajectory(np.random.default_rng(0), N,
                          LARGE_CONTINUE_MOVES + 2)
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    t = PumiTally(mesh, N, TallyConfig(check_found_all=True))
    del mesh  # the host copy
    t.CopyInitialPosition(flat(pts[0]))
    setup_s = time.perf_counter() - t1
    mesh = t.mesh
    table_bytes = sum(a.numel() * a.element_size() for a in (
        mesh.face_normals, mesh.face_offsets, mesh.face_adj))
    mesh_bytes = table_bytes + sum(a.numel() * a.element_size() for a in (
        mesh.coords, mesh.tet2vert, mesh.volumes))
    move_ms = [wall_ms(lambda: t.MoveToNextLocation(
        flat(pts[0]), flat(pts[1]), np.ones(N, np.int8), np.ones(N)))]
    expect = float(np.linalg.norm(pts[1] - pts[0], axis=1).sum())
    rels = [check_conservation("large mesh", t.flux, expect)]
    for m in range(2, LARGE_CONTINUE_MOVES + 2):
        if m == LARGE_CONTINUE_MOVES + 1:
            # This move's walk, held to the plain version on the card,
            # then timed; these launches are not the main path's.
            before = dict(kernels.launch_counts)
            args, kw = large_continue_walk(t, pts[m])
            rk = walk(*args, torch.zeros_like(t.flux), **kw)
            rp = walk_plain(*args, torch.zeros_like(t.flux), **kw)
            for f in ("elem", "done", "exited", "iters", "x", "s"):
                check_equal(f"large mesh {f}", getattr(rk, f),
                            getattr(rp, f))
            err = check_flux("large mesh", rk.flux, rp.flux)
            times = large_walk_times(args, kw, LARGE_PASSES)
            kernels.launch_counts.update(before)
        move_ms.append(wall_ms(
            lambda m=m: t.MoveToNextLocation(None, flat(pts[m]))))
        expect += float(np.linalg.norm(pts[m] - pts[m - 1], axis=1).sum())
        rels.append(check_conservation("large mesh", t.flux, expect))
    counts = dict(kernels.launch_counts)
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"# large mesh on {card}: {mesh.nelems} tets (float32, "
          f"unpacked: no flag), host build {build_s:.1f} s, PumiTally set-up "
          f"(upload and localization) {setup_s:.2f} s; device tables (planes and "
          f"ids) {table_bytes / 1e9:.3f} GB, whole mesh "
          f"{mesh_bytes / 1e9:.3f} GB; moves ms "
          f"{', '.join(f'{v:.3f}' for v in move_ms)} (two-phase, then "
          f"continue); conservation rel err "
          f"{', '.join(f'{r:.3e}' for r in rels)}; last move's walk vs "
          f"plain: ids, x, s bitwise, flux max abs diff {err:.3e}; its "
          f"kernel "
          f"{', '.join(f'{v:.4f}' for v in times['ms']['unpacked'])} ms "
          f"(CUDA events, {LARGE_PASSES} passes), bound "
          f"{times['bound']['unpacked']}, "
          f"{times['sm_cycles_per_crossing']['unpacked']:.1f} SM cycles a "
          f"crossing; host "
          f"peak RSS {peak_gb:.1f} GB; launches {counts}")
    return counts


def ladder_drive(t, pts, moves: int = 2) -> None:
    """CopyInitialPosition, a two-phase move, continue moves."""
    n = t.num_particles
    t.CopyInitialPosition(flat(pts[0][:n]))
    t.MoveToNextLocation(flat(pts[0][:n]), flat(pts[1][:n]),
                         np.ones(n, np.int8), np.ones(n))
    for m in range(2, moves + 1):
        t.MoveToNextLocation(None, flat(pts[m][:n]))


def check_recovered(what: str, t, ref, mesh, ids: str = "equal") -> dict:
    """A ladder run against the unconstrained run: every straggler
    recovered (unfinished_total > 0, stragglers_lost == 0, no anomalous
    move), positions bitwise, the flux total at rtol 1e-6, and by
    ``ids``: "equal", ids equal and flux at rtol 1e-4 per element
    (atomics); "contained" (a ladder that re-parametrises the ray, the
    partitioned engine's resumed phase): each id that differs from the
    unconstrained run's names a tet that holds its position (within
    1e-5): a position on a face shared by two tets (bench.py's clip
    puts many on the tets' diagonal faces) may name the other one, and
    the next move's track is attributed from there; "reported" (the
    two-tier rung 2, which walks the full-precision planes from where a
    bf16 step left the particle, possibly a neighbour of the tet that
    holds it, the select tier's tie class): the ids are counted, not
    held. Where the ids are not held equal the per-element flux is
    reported (L1 of the difference over the total). Returns the health
    report as a dict."""
    import torch

    rep = t.health_report()
    if not (rep.unfinished_total > 0 and rep.stragglers_lost == 0
            and rep.anomaly_moves == 0
            and rep.stragglers_recovered == rep.unfinished_total):
        raise AssertionError(f"{what}: health report {rep}")
    pos, pos_ref = t.positions, ref.positions
    if not np.array_equal(pos, pos_ref):
        raise AssertionError(f"{what}: positions differ from the "
                             "unconstrained run")
    e, e_ref = t.elem_ids, ref.elem_ids
    if ids == "equal" and not np.array_equal(e, e_ref):
        raise AssertionError(f"{what}: {int((e != e_ref).sum())} ids differ")
    held = contains(mesh, pos, e, 1e-5) | (e == e_ref)
    if ids == "contained" and not held.all():
        raise AssertionError(f"{what}: {int((~held).sum())} particles "
                             "outside their element")
    if ids == "equal":
        check_flux(what, t.flux, ref.flux)
    total, total_ref = float(t.flux.double().sum()), float(
        ref.flux.double().sum())
    if abs(total - total_ref) > CONSERVATION_RTOL * total_ref:
        raise AssertionError(f"{what}: flux total {total} vs {total_ref}")
    out = rep.as_dict()
    out["ids_differing"] = int((e != e_ref).sum())
    out["ids_outside"] = int((~held).sum())
    out["flux_l1_rel"] = float((t.flux.double() - ref.flux.double()).abs()
                               .sum()) / total_ref
    return out


def count_syncs(fn) -> list:
    """The synchronizing CUDA calls ``fn`` makes, caught under
    ``torch.cuda.set_sync_debug_mode("warn")``: for each, the last
    lines of the Python stack that made it."""
    import traceback
    import warnings

    import torch

    calls = []

    def note(message, category, filename, lineno, file=None, line=None):
        # torch's wording for a flagged call (set_sync_debug_mode's own
        # warning about the mode is not one).
        if "called a synchronizing CUDA operation" in str(message):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if os.path.basename(f.filename) != "warnings.py"]
            calls.append(" < ".join(
                f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                for f in frames[::-1][:5]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return calls


def phase_sentinel(mesh, pts, card: str) -> dict:
    """The straggler ladder on the card, box, float32, max_iters=2,
    ``SentinelPolicy()``, point location first, each against an
    unconstrained run of the same facade (``check_recovered``):
    ``PumiTally`` on the float32 tables (rung 1: W0 continuing the ray
    parametrisation; ids equal) and on the two-tier tables with rung 1
    starved to one step, so rung 2 (W0's unpacked entry over the
    refinement tier's planes) recovers everyone (ids counted); the
    default ``PartitionedPumiTally`` (``retry_stragglers``: W4 resumes
    the phase; each differing id a tet holding its position); the
    two-tier run also against the same ladder with its rungs on
    ``walk_plain`` (positions and ids equal, flux rtol 1e-4);
    ``StreamingTally`` at 500,000 in chunks of 100,000 (ids equal). Then a ladder starved to one step
    (10,000 particles) loses particles and writes as many quarantine
    records; an audited continue move (unfenced, unchecked) makes one
    synchronizing call, the audit's fetch, where sentinel-off makes
    none; its ms in turns with sentinel-off. Returns the launch counts
    of the ladder runs."""
    import torch

    from pumiumtally_tpu_torch import (
        PartitionedPumiTally,
        PumiTally,
        SentinelPolicy,
        StreamingTally,
        TallyConfig,
        kernels,
    )
    from pumiumtally_tpu_torch.ops.walk import mesh_for_tier, walk_plain
    from pumiumtally_tpu_torch.sentinel import (
        SentinelRunner,
        quarantine_path,
        read_quarantine,
        straggler,
    )

    # Point location first (localization="locate"): located particles
    # retire on their first step, so the ladder works on the moves.
    base = dict(check_found_all=False, localization="locate")
    armed = dict(base, max_iters=LADDER_ITERS, sentinel=SentinelPolicy(
        on_anomaly="record"))
    cells = {
        "mono": lambda **kw: PumiTally(mesh, N, TallyConfig(**kw)),
        "part": lambda **kw: PartitionedPumiTally(mesh, N,
                                                  TallyConfig(**kw)),
        "stream": lambda **kw: StreamingTally(
            mesh, N, chunk_size=LADDER_STREAM_CHUNK,
            config=TallyConfig(**kw)),
    }
    counts, reports = {}, {}
    for key, make in cells.items():
        ref = make(**base)
        ladder_drive(ref, pts)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        t = make(**armed)
        ladder_drive(t, pts)
        sync()
        secs = time.perf_counter() - t0
        counts[f"ladder_{key}"] = dict(kernels.launch_counts)
        # W0's ladder continues the exact ray: ids equal. The engine's
        # rung resumes the phase from the pause points (its own
        # re-parametrisation): each id a tet holding its position.
        reports[key] = check_recovered(
            f"ladder {key}", t, ref, mesh,
            ids="contained" if key == "part" else "equal")
        print(f"# sentinel ladder {type(t).__name__} (float32, max_iters="
              f"{LADDER_ITERS}) on {card}: {secs:.2f} s; health "
              f"{json.dumps(reports[key])}; positions bitwise vs "
              f"unconstrained; launches {counts[f'ladder_{key}']}")
        del t, ref
    # Two-tier, rung 1 starved: rung 2 walks the refinement tier's planes.
    real, rungs = straggler._retry_step, []

    def starved_first_rung(*args, table_dtype=None, max_iters, **kw):
        rungs.append(table_dtype)
        if table_dtype is None:
            max_iters = 1
        return real(*args, table_dtype=table_dtype, max_iters=max_iters,
                    **kw)

    ref = PumiTally(mesh, N, TallyConfig(**base, **BF16))
    ladder_drive(ref, pts)
    kernels.reset_launch_counts()
    straggler._retry_step = starved_first_rung
    try:
        t = PumiTally(mesh, N, TallyConfig(**armed, **BF16))
        ladder_drive(t, pts)
        sync()
    finally:
        straggler._retry_step = real
    counts["ladder_mono_bf16"] = dict(kernels.launch_counts)
    if "float32" not in rungs or counts["ladder_mono_bf16"][
            "walk_unpacked"] == 0:
        raise AssertionError(f"ladder two-tier: rungs {rungs}, launches "
                             f"{counts['ladder_mono_bf16']}")
    reports["mono_bf16"] = check_recovered("ladder two-tier", t, ref, mesh,
                                           ids="reported")
    # The same run with the ladder's rungs on the plain version (the
    # moves' walks on the kernels, as above): rung 2's walk over the
    # planes at stride 5 held to walk_plain in its own context.
    def plain_walk(m, *a, table_dtype=None, counts=None, **kw):
        return walk_plain(mesh_for_tier(m, table_dtype), *a, **kw)

    real_walk = straggler.walk
    straggler._retry_step, straggler.walk = starved_first_rung, plain_walk
    try:
        tp = PumiTally(mesh, N, TallyConfig(**armed, **BF16))
        ladder_drive(tp, pts)
        sync()
    finally:
        straggler._retry_step, straggler.walk = real, real_walk
    check_equal("ladder two-tier vs its plain rungs: positions", t.x,
                tp.x)
    check_equal("ladder two-tier vs its plain rungs: ids", t.elem, tp.elem)
    err = check_flux("ladder two-tier vs its plain rungs", t.flux, tp.flux)
    print(f"# sentinel ladder PumiTally (two-tier, rung 1 starved to one "
          f"step) on {card}: rungs {rungs}; health "
          f"{json.dumps(reports['mono_bf16'])}; positions bitwise vs the "
          f"unconstrained two-tier run; vs the same ladder with its rungs "
          f"on walk_plain: positions and ids equal, flux max abs diff "
          f"{err:.3e}; launches {counts['ladder_mono_bf16']}")
    del t, tp, ref
    # A ladder starved to one step: the residue is lost and quarantined.
    nq = LADDER_QUARANTINE_N
    straggler._retry_step = lambda *a, max_iters, **kw: real(
        *a, max_iters=1, **kw)
    try:
        with tempfile.TemporaryDirectory() as d:
            t = PumiTally(mesh, nq, TallyConfig(**dict(armed, sentinel=(
                SentinelPolicy(quarantine_dir=d, on_anomaly="record")))))
            t.CopyInitialPosition(flat(pts[0][:nq]))
            t.MoveToNextLocation(None, flat(pts[1][:nq]))
            records = read_quarantine(quarantine_path(d))
    finally:
        straggler._retry_step = real
    lost = t.lost_particles
    if not lost or len(records) != lost or \
            t.health_report().stragglers_lost != lost:
        raise AssertionError(f"quarantine: {len(records)} records, "
                             f"{lost} lost")
    print(f"# sentinel quarantine (ladder starved to one step, {nq} "
          f"particles): {lost} lost, {len(records)} records")
    # The audit's cost: one fetch a move, and its ms beside sentinel-off.
    quiet = dict(base, fenced_timing=False)
    arms = {"off": PumiTally(mesh, N, TallyConfig(**quiet)),
            "on": PumiTally(mesh, N, TallyConfig(
                **quiet, sentinel=SentinelPolicy()))}
    for t in arms.values():
        t.CopyInitialPosition(flat(pts[0]))
        t.MoveToNextLocation(None, flat(pts[1]))
    sync()
    src = iter(range(2, 10 ** 6))

    def move(t):
        t.MoveToNextLocation(None, flat(pts[2 + next(src) % 2]))

    calls = {k: count_syncs(lambda t=t: move(t)) for k, t in arms.items()}
    syncs = {k: len(v) for k, v in calls.items()}
    if syncs != {"off": 0, "on": 1}:
        raise AssertionError(f"audit syncs: {calls}")
    turns = in_turns({k: (lambda t=t: move(t)) for k, t in arms.items()},
                     wall_ms, passes=LADDER_PASSES)
    rep = arms["on"].health_report()
    if rep.anomaly_moves or rep.max_conservation_residual > 1e-5:
        raise AssertionError(f"audited moves: {rep}")
    # The audit alone on a move's tensors, by a runner of its own (the
    # facade's carries its flux sum): device ms (CUDA events) and wall ms
    # with its fetch.
    t = arms["on"]
    runner = SentinelRunner(SentinelPolicy(), t.dtype, t.device)
    view = (t.x, t.x.flip(0), t._cached_ones("fly"), t._cached_ones("w"),
            torch.ones((N,), dtype=torch.bool, device=t.device), t.flux)
    audit_ms = cuda_ms(lambda: runner.audit(*view))
    audit_wall = [wall_ms(lambda: runner.audit(*view)) for _ in range(4)]
    print(f"# sentinel audit on {card}: synchronizing calls a continue move "
          f"{syncs} (set_sync_debug_mode('warn')); continue move ms (wall, "
          f"fenced by the timer, in turns): " + "; ".join(
              f"{k} {', '.join(f'{v:.3f}' for v in t)}"
              for k, t in turns.items())
          + f"; the audit alone {audit_ms:.4f} ms (CUDA events), "
          f"{', '.join(f'{v:.3f}' for v in audit_wall)} ms wall with its "
          f"fetch; worst residual {rep.max_conservation_residual:.3e}")
    return counts


def phase_xpoints(mesh, pts, card: str) -> None:
    """``PumiTally(record_xpoints=True)`` at 500,000 particles on the box:
    a two-phase move, then ``intersection_points()`` (timed): a particle
    whose move stayed in one tet returns its start, one that crossed a
    face returns a point on a face plane of its final element (within
    1e-5)."""
    import torch

    from pumiumtally_tpu_torch import PumiTally, TallyConfig

    t = PumiTally(mesh, N, TallyConfig(record_xpoints=True))
    t.CopyInitialPosition(flat(pts[0]))
    if not np.array_equal(t.intersection_points(), t.positions):
        raise AssertionError("xpoints before a move: not the positions")
    e0, x0 = t.elem_ids.copy(), t.positions.copy()
    t.MoveToNextLocation(flat(pts[0]), flat(pts[1]), np.ones(N, np.int8),
                         np.ones(N))
    t0 = time.perf_counter()
    xp = t.intersection_points()
    ms = (time.perf_counter() - t0) * 1e3
    e1 = t.elem_ids
    stayed = e1 == e0
    if not np.array_equal(xp[stayed], x0[stayed]):
        raise AssertionError("xpoints: a particle that stayed in its tet "
                             "did not return its start")
    crossed = ~stayed
    e = torch.as_tensor(e1[crossed], dtype=torch.long, device=t.device)
    p = torch.as_tensor(xp[crossed], dtype=t.dtype, device=t.device)
    dist = ((t.mesh.face_normals[e] * p[:, None, :]).sum(dim=2)
            - t.mesh.face_offsets[e]).abs().min(dim=1).values
    worst = float(dist.max())
    if worst > 1e-5:
        raise AssertionError(f"xpoints: {worst} off a face plane")
    print(f"# intersection_points on {card}: {N} particles, {ms:.1f} ms "
          f"(replay, plain PyTorch); {int(crossed.sum())} crossed a face, "
          f"worst distance to a face plane of the final element "
          f"{worst:.3e}; {int(stayed.sum())} stayed in their tet and "
          f"returned their start")


# ---------------------------------------------------------------------------
# Phase 14: the deterministic commit (csrc/det_commit.cu) and the
# resilience layer
# ---------------------------------------------------------------------------

DET_PASSES = 4
# W0's cells: (label, mesh layout, scoring) and W4's: (label, engine
# knobs, scoring); each runs in float32 at N and float64 at W0_F64_N.
DET_W0_CELLS = (("packed", "packed", False), ("two-tier", "two-tier", False),
                ("unpacked ROW16", "row16", False),
                ("unpacked ROW20", "row20", False),
                ("scoring", "packed", True))
DET_W4_CELLS = (("one block", {}, False), ("sub-split", W4_SUBSPLIT, False),
                ("two-tier", dict(table_dtype="bfloat16"), False),
                ("scoring", {}, True))
# The resilience campaign: CAMPAIGN_BATCHES source batches of
# CAMPAIGN_MOVES continue moves on bench.py's trajectory, autosaved every
# batch; StreamingTally in chunks of CAMPAIGN_CHUNK.
CAMPAIGN_BATCHES, CAMPAIGN_MOVES = 3, 2
CAMPAIGN_CHUNK = 250_000
CAMPAIGN_FACADES = ("PumiTally", "StreamingTally", "PartitionedPumiTally")
CAMPAIGN_TIMEOUT = 300  # seconds, each campaign subprocess


class SerialCpu:
    """One intra-op CPU thread inside the block: the order of a serial
    CPU index_add_ (torch may split a large one across threads)."""

    def __enter__(self):
        import torch

        self.threads = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        import torch

        torch.set_num_threads(self.threads)


def det_counts(ws, x) -> tuple:
    """The record counts of the last deterministic walk with the
    workspace ``ws`` on ``x``'s device and dtype: (flux, lanes)."""
    return tuple(int(ws.records(x.device, x.dtype, name, 0).count)
                 for name in ("flux", "lanes"))


def det_small_workspace(x):
    """A deterministic-commit workspace whose streams hold 1,024 records
    (the least), so that a walk overflows them."""
    from pumiumtally_tpu_torch.ops.det_commit import DetWorkspace

    ws = DetWorkspace()
    for name in ("flux", "lanes"):
        ws.records(x.device, x.dtype, name, 0)
    return ws


def check_det_regrown(what: str, ws, x, records: tuple) -> None:
    """The small workspace's streams grew to hold the walk's records."""
    for name, m in zip(("flux", "lanes"), records):
        rec = ws.records(x.device, x.dtype, name, 0)
        if m > 1024 and not (rec.cap >= m and int(rec.count) == m):
            raise AssertionError(f"{what}: the {name} stream holds "
                                 f"{rec.cap} records after a walk of {m}")


def check_bitwise(what: str, got, want) -> None:
    import torch

    if not torch.equal(got.cpu(), want.cpu()):
        bad = int((got.cpu() != want.cpu()).sum())
        raise AssertionError(f"{what}: {bad} entries differ")


def det_w0_cell(mesh, label: str, layout: str, scored: bool, pts, n: int,
                cpu: bool) -> dict:
    """W0's deterministic instantiation on one cell against the plain
    version: two launches on the same inputs equal bitwise (flux and
    lanes); equal bitwise to ``walk_plain(deterministic=True)`` on the
    card (its records through ``det_commit_plain``), positions, ids and
    s too; with ``cpu`` equal bitwise to ``walk_plain`` on the CPU, its
    serial ``index_add_`` (one thread); flux conserved at rtol 1e-6; a
    walk whose record streams are far too small (grown and made again)
    equal to it bitwise."""
    import torch

    from pumiumtally_tpu_torch.ops.det_commit import DetWorkspace
    from pumiumtally_tpu_torch.ops.walk import walk, walk_plain
    from pumiumtally_tpu_torch.scoring import ScoringRuntime

    ws = DetWorkspace()
    args, kw = w0_inputs(mesh, pts, layout in ("two-tier", "row20"), n)
    args = (unpacked_layout(args[0], layout), *args[1:])
    m, x = args[:2]
    spec = score_spec() if scored else None
    sc_in = None
    if scored:
        rt = ScoringRuntime(spec, m.nelems, x.dtype, x.device)
        sbin, sfac, _ = score_lanes(rt, n, 5)
        sc_in = (rt.bank_size, sbin, sfac)

    def run(fn, a, dev, det):
        flux = torch.zeros((m.nelems,), dtype=x.dtype, device=dev)
        sc = bank = None
        if scored:
            bank = torch.zeros((sc_in[0],), dtype=x.dtype, device=dev)
            sc = (spec.kinds, bank, sc_in[1].to(dev), sc_in[2].to(dev))
        return fn(*a, flux, **kw, scoring=sc, deterministic=det), bank

    name = f"W0 det {label} ({str(x.dtype)[6:]}, {n})"
    (r1, b1), (r2, b2) = (run(walk, args, x.device, ws) for _ in range(2))
    records = det_counts(ws, x)
    rp, bp = run(walk_plain, args, x.device, True)
    # Streams far too small: the walk overflows them, grows them and is
    # made again; the result must not change.
    small = det_small_workspace(x)
    rs, bs = run(walk, args, x.device, small)
    sync()
    check_det_regrown(name, small, x, records)
    check_bitwise(f"{name} flux after regrowing", rs.flux, r1.flux)
    if scored:
        check_bitwise(f"{name} lanes after regrowing", bs, b1)
    check_bitwise(f"{name} flux, two launches", r1.flux, r2.flux)
    check_bitwise(f"{name} flux vs plain", r1.flux, rp.flux)
    for f in ("elem", "x", "s", "done", "exited"):
        check_bitwise(f"{name} {f} vs plain", getattr(r1, f), getattr(rp, f))
    if scored:
        check_bitwise(f"{name} lanes, two launches", b1, b2)
        check_bitwise(f"{name} lanes vs plain", b1, bp)
    expect = float((args[5].double()
                    * (r1.x.double() - x.double()).norm(dim=1)).sum())
    rel = check_conservation(name, r1.flux, expect)
    cpu_note = "CPU not compared"
    if cpu:
        ca = (m.to(device="cpu"), *(a.cpu() for a in args[1:]))
        t0 = time.perf_counter()
        with SerialCpu():
            rc, bc = run(walk_plain, ca, "cpu", False)
        check_bitwise(f"{name} flux vs CPU plain", r1.flux, rc.flux)
        check_bitwise(f"{name} x vs CPU plain", r1.x, rc.x)
        if scored:
            check_bitwise(f"{name} lanes vs CPU plain", b1, bc)
        cpu_note = (f"CPU plain (serial index_add_) bitwise, "
                    f"{time.perf_counter() - t0:.1f} s")
    print(f"# {name}: {records[0]} flux records"
          f"{f', {records[1]} lane records' if scored else ''}; two "
          f"launches bitwise; streams grown from 1,024 records bitwise; "
          f"bitwise vs plain on the card; {cpu_note}; conservation rel "
          f"err {rel:.3e}")
    return {"args": args, "kw": kw, "spec": spec, "sc_in": sc_in,
            "records": records, "flux": r1.flux, "ws": ws}


def det_w4_cell(mesh, label: str, knobs: dict, scored: bool, pts, n: int,
                cpu: bool) -> dict:
    """W4's deterministic instantiation on one cell: round 1 of the first
    move (no list) and, where particles pause at block faces, round 2 over
    the work list of the migrated state, each against the plain version
    as ``det_w0_cell`` holds W0 (two launches, the card's plain version,
    the CPU's serial ``index_add_`` with ``cpu``) and each round's flux
    conserved at rtol 1e-6 (the walked slots' track from their start to
    where they stopped); a walk whose record streams are far too small
    (its rows put back, the streams grown, the walk made again) equal to
    it bitwise, rows and flux."""
    import torch

    from pumiumtally_tpu_torch.ops.det_commit import DetWorkspace
    from pumiumtally_tpu_torch.parallel import partition

    ws = DetWorkspace()
    spec = score_spec() if scored else None
    eng, _, st = w4_engine(mesh, pts, n, spec=spec, **knobs)
    name = f"W4 det {label} ({str(st['x'].dtype)[6:]}, {n})"
    kw = dict(tally=True, tol=eng.tol, max_iters=eng.max_iters,
              blocks=eng.nparts)
    tables = (eng.part.table, eng.part.adj_int, eng.part.table_hi)

    def run(fn, rnd, work, dev, det):
        rows = {k: v.to(dev).clone() for k, v in rnd.items()}
        flux = torch.zeros_like(eng.flux_padded, device=dev)
        sc = bank = None
        if scored:
            bank = torch.zeros_like(eng.score_padded, device=dev)
            sc = (spec.kinds, bank, rows["sbin"], rows["sfac"])
        tab, adj, hi = (None if t is None else t.to(dev) for t in tables)
        w = None if work is None else tuple(t.to(dev) for t in work)
        res = fn(tab, *(rows[k] for k in W4_KEYS), flux, w, adj_int=adj,
                 table_hi=hi, scoring=sc, deterministic=det, **kw)
        return res, bank

    rounds, rnd, work, notes = [], st, None, []
    for r in (1, 2):
        (a, ba), (b, bb) = (run(partition.walk_local_list, rnd, work,
                                st["x"].device, ws) for _ in range(2))
        records = det_counts(ws, st["x"])
        p, bp = run(partition.walk_local_list_plain, rnd, work,
                    st["x"].device, True)
        # Streams far too small: the in-place walk overflows them, its
        # rows are put back, the streams grow and it is made again.
        small = det_small_workspace(st["x"])
        q, bq = run(partition.walk_local_list, rnd, work, st["x"].device,
                    small)
        sync()
        check_det_regrown(f"{name} round {r}", small, st["x"], records)
        for i, f in enumerate(("x", "lelem", "done", "exited", "pending",
                               "flux")):
            check_bitwise(f"{name} round {r} {f} after regrowing", q[i],
                          a[i])
        if scored:
            check_bitwise(f"{name} round {r} lanes after regrowing", bq, ba)
        check_bitwise(f"{name} round {r} flux, two launches", a[5], b[5])
        check_bitwise(f"{name} round {r} flux vs plain", a[5], p[5])
        for i, f in enumerate(("x", "lelem", "done", "exited", "pending")):
            check_bitwise(f"{name} round {r} {f} vs plain", a[i], p[i])
        if scored:
            check_bitwise(f"{name} round {r} lanes, two launches", ba, bb)
            check_bitwise(f"{name} round {r} lanes vs plain", ba, bp)
        # The round's track: each walked slot from its start to where it
        # stopped (its destination, the boundary or a block face).
        expect = float((rnd["w"].double() * (a[0].double()
                        - rnd["x"].double()).norm(dim=1)).sum())
        rel = check_conservation(f"{name} round {r}", a[5], expect)
        if cpu:
            with SerialCpu():
                c, bc = run(partition.walk_local_list_plain, rnd, work,
                            "cpu", False)
            check_bitwise(f"{name} round {r} flux vs CPU plain", a[5], c[5])
            check_bitwise(f"{name} round {r} x vs CPU plain", a[0], c[0])
            if scored:
                check_bitwise(f"{name} round {r} lanes vs CPU plain", ba, bc)
        rounds.append({"round": rnd, "work": work, "records": records})
        notes.append(f"round {r}: {records[0]} flux records"
                     f"{f', {records[1]} lane records' if scored else ''}"
                     f", conservation rel err {rel:.3e}")
        paused = int((a[4] >= 0).sum())
        if paused == 0:
            break
        nxt = dict(rnd, x=a[0], lelem=a[1], done=a[2], exited=a[3],
                   pending=a[4])
        rnd, overflow = partition.migrate(eng.part.L, eng.nparts,
                                          eng.cap_per_block, nxt)
        if overflow:
            raise AssertionError(f"{name}: round 2's migrate overflowed")
        work = partition.work_list(rnd["done"])
    print(f"# {name}: {eng.nparts} block(s); " + "; ".join(notes)
          + "; two launches bitwise; streams grown from 1,024 records "
          "(rows put back) bitwise; bitwise vs plain on the card"
          + ("; CPU plain (serial index_add_) bitwise" if cpu else ""))
    return {"eng": eng, "spec": spec, "rounds": rounds, "run": run,
            "ws": ws}


def det_commit_times(label: str, rec, m: int, target, smi: str) -> dict:
    """DC alone on ``m`` records of stream ``rec`` into a copy of
    ``target`` (``dc_regime``: bitwise against ``det_commit_plain``, its
    ms and its kernels', ``index_put_`` deterministic, the bound), with
    the plain version's wall ms: the kernel line's fields."""
    from pumiumtally_tpu_torch.ops.det_commit import det_commit_plain

    r = dc_regime(label, rec, m, target, smi)
    scratch = target.clone()
    plain_ms = wall_ms(lambda: det_commit_plain(scratch, rec.key[:m],
                                                rec.ord[:m], rec.val[:m]))
    return {"ms": float(np.median(r["ms"])), "ms_passes": r["ms"],
            "plain_ms": plain_ms,
            "library_ms": float(np.median(r["index_put_ms"])),
            "library_passes": r["index_put_ms"], "max_abs_err": 0.0,
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}


# DC alone on records made from a seed (phase 14): (label, records, keys,
# dtype, layout). "hot": every record on one key (a tile past the stage:
# the over-full path); "tk+1": K one past the plan's tile width, with
# the records that plan it so (a last tile of one key); otherwise keys
# uniform over [0, K).
DC_CELLS = (
    ("one hot key", 100_000, MESH_DIV ** 3 * 6, "float32", "hot"),
    ("m below one tile", 1_000, MESH_DIV ** 3 * 6, "float32", "uniform"),
    ("K = 1", 3_000, 1, "float32", "uniform"),
    ("K = TK + 1", 0, 1_025, "float32", "tk+1"),
    ("uniform keys over 4.6M lanes", 20_000_000, 4_608_000, "float32",
     "uniform"),
    ("float64", 2_000_000, MESH_DIV ** 3 * 6, "float64", "uniform"),
    ("float64, one hot key", 50_000, MESH_DIV ** 3 * 6, "float64", "hot"),
    ("300M-entry bank (key groups)", 1_000_000, 300_000_000, "float32",
     "uniform"),
)


def dc_cell_records(m: int, K: int, dtype, layout: str, seed: int):
    """A record stream of ``m`` records into ``K`` entries on the card:
    ords ``step << 32 | pid`` with distinct pids (so a key's ords are
    distinct), values in [-0.5, 1.5), and a standing target in [0, 1).
    For ``tk+1``, ``m`` is chosen so that DC's plan cuts ``K - 1`` keys
    a tile. Returns (stream, m, target)."""
    import torch

    from pumiumtally_tpu_torch.ops import det_commit as dc

    dev = torch.device("cuda")
    if layout == "tk+1":
        half = dc.dc_plan(1, K, dtype.itemsize,
                          *dc.device_smem(dev)).stage // 2
        m = next(c for c in range(half - 64, half + 64)
                 if dc.dc_plan(c, K, dtype.itemsize,
                               *dc.device_smem(dev)).tk == K - 1)
    g = torch.Generator().manual_seed(seed)
    rec = dc.DetRecords(dev, dtype)
    rec.reserve(m)
    key = (torch.full((m,), K // 3, dtype=torch.int32) if layout == "hot"
           else torch.randint(0, K, (m,), generator=g, dtype=torch.int32))
    step = torch.randint(0, 64, (m,), generator=g, dtype=torch.int64)
    rec.key[:m] = key.to(dev)
    rec.ord[:m] = ((step << 32) | torch.randperm(m, generator=g)).to(dev)
    rec.val[:m] = (torch.rand(m, generator=g, dtype=torch.float64) * 2
                   - 0.5).to(dtype).to(dev)
    target = torch.rand(K, generator=g, dtype=torch.float64).to(dtype)
    return rec, m, target.to(dev)


def phase_dc_cells() -> list:
    """DC alone on the DC_CELLS, each bitwise against
    ``det_commit_plain`` on the same records and standing target: the
    plan, the largest bucket and tile, the tiles the over-full path
    took (``DetRecords.overfull``: at least one on the hot cells, none
    elsewhere), and DC's ms (CUDA events). Returns the cells' lines."""
    import torch

    from pumiumtally_tpu_torch.ops import det_commit as dc

    out = []
    for i, (label, m, K, dtype, layout) in enumerate(DC_CELLS):
        dt = getattr(torch, dtype)
        rec, m, target = dc_cell_records(m, K, dt, layout, 40 + i)
        got, want = target.clone(), target.clone()
        dc.det_commit(got, rec, m)
        sync()
        overfull = int(rec.overfull)
        dc.det_commit_plain(want, rec.key[:m], rec.ord[:m], rec.val[:m])
        sync()
        check_bitwise(f"DC cell {label}", got, want)
        stats = dc_stats(rec, m, K, dt.itemsize)
        if layout == "tk+1" and (stats["tk"] != K - 1 or stats["tiles"] != 2):
            raise AssertionError(f"DC cell {label}: plan {stats}")
        if (overfull > 0) != (layout == "hot"):
            raise AssertionError(f"DC cell {label}: {overfull} tiles took "
                                 f"the over-full path ({stats})")
        ms = cuda_ms(lambda: dc.det_commit(got, rec, m), reps=2)
        line = {"dc_cell": label, "dtype": dtype, **stats,
                "overfull": overfull, "ms": ms}
        print(f"# DC cell {label}: bitwise vs det_commit_plain"
              + (f"; the over-full path took {overfull} tile(s)"
                 if overfull else "")
              + f"; {json.dumps(line)}")
        out.append(line)
        del rec, got, want, target
    return out


def phase_det_kernels(mesh, pts) -> dict:
    """The deterministic commit's kernels against their plain versions:
    W0 (packed, two-tier, unpacked, scoring) and W4 (one block, the
    gather sub-split, two-tier, scoring) on the box in float32 at N
    particles and float64 at W0_F64_N, as ``det_w0_cell`` /
    ``det_w4_cell`` hold them (the CPU's serial index_add_ on the float64
    cells and the packed float32 W0 cell). Then, per float32 cell, the
    walk with the deterministic commit against the atomic one in turns
    (CUDA events, DET_PASSES passes, into standing buffers), and DC
    alone on the cell's flux records (``det_commit_times``). Returns the
    kernel line's entry: DC on the packed float32 W0 cell's flux."""
    import torch

    from pumiumtally_tpu_torch import build_box
    from pumiumtally_tpu_torch.ops.walk import walk

    box64 = build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                      dtype=torch.float64)
    entry = None
    for m, n in ((mesh, N), (box64, W0_F64_N)):
        f32 = m.dtype == torch.float32
        for label, layout, scored in DET_W0_CELLS:
            cell = det_w0_cell(m, label, layout, scored, pts, n,
                               cpu=not f32 or label == "packed")
            if not f32:
                continue
            args, kw, spec, sc_in, ws = (cell[k] for k in
                                         ("args", "kw", "spec", "sc_in",
                                          "ws"))
            x = args[1]
            flux = torch.zeros_like(cell["flux"])
            bank = None if spec is None else torch.zeros(
                (sc_in[0],), dtype=x.dtype, device=x.device)
            sc = None if spec is None else (spec.kinds, bank, *sc_in[1:])
            turns = in_turns({
                "atomic": lambda: walk(*args, flux, **kw, scoring=sc),
                "deterministic": lambda: walk(*args, flux, **kw, scoring=sc,
                                              deterministic=ws),
            }, cuda_ms, passes=DET_PASSES)
            walk(*args, torch.zeros_like(flux), **kw, scoring=sc,
                 deterministic=ws)  # the records of one move
            rec = ws.records(x.device, x.dtype, "flux", 0)
            t = det_commit_times(f"W0 det {label} flux", rec,
                                 cell["records"][0], torch.zeros_like(flux),
                                 nvidia_smi("name,power.limit"))
            print(f"# W0 det {label}: a move in turns (CUDA events, ms): "
                  + "; ".join(f"{a} {', '.join(f'{v:.4f}' for v in s)}"
                              for a, s in turns.items())
                  + f"; {cell['records'][0]} flux records; DC alone "
                  f"{', '.join(f'{v:.4f}' for v in t['ms_passes'])} ms, "
                  f"plain {t['plain_ms']:.3f} ms, index_put_ deterministic "
                  f"{', '.join(f'{v:.4f}' for v in t['library_passes'])} "
                  f"ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
            if label == "packed":
                entry = {"name": "DC deterministic commit (W0 box flux)",
                         "route": "cuda",
                         "source": "pumiumtally_tpu_torch/csrc/det_commit.cu",
                         "replaces": "pumiumtally_tpu/ops/walk.py:196", **t}
        for label, knobs, scored in DET_W4_CELLS:
            cell = det_w4_cell(m, label, knobs, scored, pts, n,
                               cpu=not f32)
            if not f32:
                continue
            run, ws, r1 = cell["run"], cell["ws"], cell["rounds"][0]
            x = r1["round"]["x"]
            turns = in_turns({
                "atomic": lambda: run(partition_list(), r1["round"], None,
                                      x.device, False),
                "deterministic": lambda: run(partition_list(), r1["round"],
                                             None, x.device, ws),
            }, cuda_ms, passes=DET_PASSES)
            print(f"# W4 det {label}, round 1 (with its copies of the "
                  "slot rows) in turns (CUDA events, ms): "
                  + "; ".join(f"{a} {', '.join(f'{v:.4f}' for v in s)}"
                              for a, s in turns.items())
                  + f"; {r1['records'][0]} flux records")
    return entry


# The block walks' deterministic cells (phase 14): (label, kind, scoring),
# each on the box's sub-split (blocks of <= VMEM_BOUND elements), float32
# at N particles and float64 at W0_F64_N.
DET_BLOCK_CELLS = (("W1", "W1", False), ("W2", "W2", False),
                   ("W2 scoring", "W2", True))
DET_BLOCK_ENTRIES = {  # cell -> (kernel line name, source, replaces)
    "W1": ("W1 block_walk, deterministic commit (kDet)", "block_walk.cu",
           "pumiumtally_tpu/ops/vmem_walk.py:250"),
    "W2": ("W2 twotier_block_walk, deterministic commit (kDet)",
           "twotier_block_walk.cu", "pumiumtally_tpu/ops/pallas_walk.py:175"),
    "W2 scoring": ("W2 twotier_block_walk_scored, deterministic commit "
                   "(kDet)", "twotier_block_walk.cu",
                   "pumiumtally_tpu/ops/pallas_walk.py:475"),
}
# W0's segmented commit (the service's fused launch): SEG_K sessions of
# N / SEG_K particles in one slab and one padding row at SEG_K * E that
# walks and must tally nowhere; (label, layout, scoring).
SEG_K = 8
SEG_CELLS = (("packed", "packed", False), ("two-tier", "two-tier", False),
             ("scoring", "packed", True), ("unpacked ROW16", "row16", False),
             ("unpacked ROW20", "row20", False))


def block_round1(mesh, pts, kind: str, n: int, spec=None) -> tuple:
    """The first move's tallied round 1 on the box's sub-split as a
    ``PartitionedPumiTally`` builds it (W1 on the packed table; W2 on the
    two-tier tables, ``walk_kernel="pallas"``): (engine, tables, the
    kernel's keywords, the slot state, with ``sbin``/``sfac`` rows from
    ``score_lanes`` when ``spec``)."""
    import torch

    from pumiumtally_tpu_torch import PartitionedPumiTally, TallyConfig

    w2 = kind == "W2"
    t = PartitionedPumiTally(
        mesh, n, TallyConfig(capacity_factor=CAPACITY_FACTOR,
                             walk_vmem_max_elems=VMEM_BOUND, scoring=spec,
                             check_found_all=False,
                             **(dict(walk_kernel="pallas", **BF16) if w2
                                else {})))
    t.CopyInitialPosition(flat(pts[0][:n]))
    eng = t.engine
    st = dict(eng.state)
    st["fly"] = st["alive"].to(torch.int8)
    st["w"] = st["fly"].to(t.dtype)
    st["done"] = ~st["alive"]
    st["exited"] = torch.zeros_like(st["done"])
    st["dest"] = eng._by_pid(torch.as_tensor(pts[1][:n], dtype=t.dtype,
                                             device=t.device), 0.0)
    if spec is not None:
        sbin_n, sfac_n, _ = score_lanes(t._scoring, n, 6)
        st["sbin"] = eng._by_pid(sbin_n, 0)
        st["sfac"] = eng._by_pid(sfac_n, 0.0)
    tables = ((eng.part.table, eng.part.table_hi) if w2
              else (eng.part.table,))
    kw = dict(tally=True, tol=eng.tol, max_iters=eng.max_iters,
              blocks=eng.nparts)
    return eng, tables, kw, st


def det_block_cell(mesh, label: str, kind: str, scored: bool, pts,
                   n: int) -> dict:
    """W1's or W2's deterministic instantiation on round 1 of the first
    move against its plain version: two launches bitwise (flux, lanes),
    bitwise the plain version with ``deterministic=True`` on the card
    (every output), a walk whose record streams are far too small (grown
    and made again) bitwise, flux conserved at rtol 1e-6. In float32:
    the walk with the deterministic commit against the atomic one in
    turns (CUDA events, DET_PASSES passes), the plain version's ms and
    the bound (the round's bytes, the records written once, the
    crossings' operations). Returns the kernel line's entry (float32)."""
    import torch

    from pumiumtally_tpu_torch.experiments.block_rounds import round_bytes
    from pumiumtally_tpu_torch.ops.det_commit import DetWorkspace
    from pumiumtally_tpu_torch.ops.pallas_walk import (
        pallas_walk_local,
        pallas_walk_local_plain,
    )
    from pumiumtally_tpu_torch.ops.vmem_walk import (
        vmem_walk_local,
        vmem_walk_local_plain,
    )

    ws = DetWorkspace()
    spec = score_spec() if scored else None
    eng, tables, kw, st = block_round1(mesh, pts, kind, n, spec)
    x = st["x"]
    w2 = kind == "W2"
    fn, plain = ((pallas_walk_local, pallas_walk_local_plain) if w2
                 else (vmem_walk_local, vmem_walk_local_plain))
    name = f"{label} det ({str(x.dtype)[6:]}, {n})"

    def run(f, det):
        flux = torch.zeros_like(eng.flux_padded)
        bank, sc = None, {}
        if scored:
            bank = torch.zeros_like(eng.score_padded)
            sc = dict(scoring=(spec.kinds, bank, st["sbin"], st["sfac"]))
        r = f(*tables, st["x"], st["lelem"], st["dest"], st["fly"], st["w"],
              st["done"], st["exited"], flux, deterministic=det, **kw, **sc)
        return r, bank

    (a, ba), (b, bb) = run(fn, ws), run(fn, ws)
    records = det_counts(ws, x)
    p, bp = run(plain, True)
    small = det_small_workspace(x)
    q, bq = run(fn, small)
    sync()
    check_det_regrown(name, small, x, records)
    outs = ("x", "lelem", "done", "exited", "pending", "flux", "iters")
    for i, f in enumerate(outs):
        check_bitwise(f"{name} {f} vs plain", a[i], p[i])
        check_bitwise(f"{name} {f} after regrowing", q[i], a[i])
    check_bitwise(f"{name} flux, two launches", a[5], b[5])
    if scored:
        check_bitwise(f"{name} lanes, two launches", ba, bb)
        check_bitwise(f"{name} lanes vs plain", ba, bp)
        check_bitwise(f"{name} lanes after regrowing", bq, ba)
    expect = float((st["w"].double()
                    * (a[0].double() - x.double()).norm(dim=1)).sum())
    rel = check_conservation(name, a[5], expect)
    note = (f"# {name}: {eng.nparts} blocks; {records[0]} flux records"
            f"{f', {records[1]} lane records' if scored else ''}; two "
            f"launches bitwise; streams grown from 1,024 records bitwise; "
            f"bitwise vs plain on the card; conservation rel err {rel:.3e}")
    if x.dtype != torch.float32:
        print(note)
        return {}
    turns = in_turns({"atomic": lambda: run(fn, False),
                      "deterministic": lambda: run(fn, ws)}, cuda_ms,
                     passes=DET_PASSES)
    plain_ms = wall_ms(lambda: run(plain, True))
    L = eng.part.L
    step = twotier_step(*tables) if w2 else packed_step(tables[0])
    S = x.shape[0]
    base = (torch.arange(S, device=x.device) // eng.cap_per_block) * L
    dest_c = x + (st["dest"] - x) if w2 else st["dest"]
    crossings = count_crossings(step, x, st["lelem"], dest_c, ~st["done"],
                                base, eng.tol)
    k = x.element_size()
    nbytes = round_bytes(st["done"], st["exited"], eng.nparts, L,
                         32 + 4 * 20 if w2 else 80, k)
    # Each record written once (key, ord, value).
    nbytes += sum(records) * (4 + 8 + k)
    if scored:
        # The slots' bin offsets and factors, each bank lane touched read
        # and written once.
        nbytes += S * (4 + spec.n_scores * k) + 2 * records[1] * k
    bound = bound_entry(nbytes, crossings,
                        FLOPS_PER_CROSSING_TWO_TIER if w2
                        else FLOPS_PER_CROSSING)
    print(note + "; round 1 in turns (CUDA events, ms): "
          + "; ".join(f"{arm} {', '.join(f'{v:.4f}' for v in s)}"
                      for arm, s in turns.items())
          + f"; plain (deterministic) {plain_ms:.3f} ms; {crossings} "
          f"crossings; bound {bound}")
    ename, src, line = DET_BLOCK_ENTRIES[label]
    return {"name": ename, "route": "cuda",
            "source": f"pumiumtally_tpu_torch/csrc/{src}", "replaces": line,
            "max_abs_err": 0.0,
            "ms": float(np.median(turns["deterministic"])),
            "plain_ms": plain_ms, **bound, "library_ms": None,
            "entry": "twotier_block_walk_scored" if scored
            else "twotier_block_walk" if w2 else "block_walk"}


def seg_w0_cell(mesh, label: str, layout: str, scored: bool, pts) -> dict:
    """W0's segmented commit on one slab: SEG_K sessions of N / SEG_K
    particles each (session k's flux at k*E + elem of a [SEG_K*E] bank;
    with scoring its bin offsets shifted by k*E*stride, a dropped one at
    the bank's end) and one padding row at offset SEG_K*E that walks.
    The atomic commit: positions, ids, s and flags bitwise its plain
    version, flux rtol 1e-4, lanes by ``check_bank``. The deterministic
    commit (kDet): two launches bitwise, bitwise its plain version (flux,
    lanes, positions). Each segment's flux conserves its own sessions'
    track at rtol 1e-6, the padding row's tallies nowhere. Timed in turns
    (CUDA events) against the same slab without segments into one [E]
    flux. Returns the kernel line's entry."""
    import torch

    from pumiumtally_tpu_torch.ops.det_commit import DetWorkspace
    from pumiumtally_tpu_torch.ops.walk import advance_mesh, walk, walk_plain
    from pumiumtally_tpu_torch.scoring import ScoringRuntime

    args, kw = w0_inputs(mesh, pts, layout in ("two-tier", "row20"), N)
    args = (unpacked_layout(args[0], layout), *args[1:])
    m, x, elem, dest, fly, w = args
    dev, dt = x.device, x.dtype
    E, per = m.nelems, N // SEG_K
    # The padding row: particle 0 again, walking to particle 1's
    # destination.
    args = (m, torch.cat([x, x[:1]]), torch.cat([elem, elem[:1]]),
            torch.cat([dest, dest[1:2]]), torch.cat([fly, fly[:1]]),
            torch.cat([w, w[:1]]))
    x = args[1]
    n = x.shape[0]
    k_of = (torch.arange(n, device=dev) // per).clamp(max=SEG_K - 1)
    k_of[-1] = SEG_K
    seg = (k_of * E).to(torch.int32)
    spec = sc_in = None
    if scored:
        spec = score_spec()
        rt = ScoringRuntime(spec, E, dt, dev)
        sbin, sfac, _ = score_lanes(rt, n, 5)
        drop = SEG_K * E * rt.stride
        sbin = torch.where(sbin >= rt.stride, torch.full_like(sbin, drop),
                           sbin + seg * rt.stride).to(torch.int32)
        sc_in = (drop, sbin, sfac)
    ws = DetWorkspace()
    name = f"W0 seg {label} (K={SEG_K}, {N} + 1 padding row)"

    def run(fn, det, segmented=True):
        flux = torch.zeros((SEG_K * E if segmented else E,), dtype=dt,
                           device=dev)
        bank = sc = None
        if scored and segmented:
            bank = torch.zeros((sc_in[0],), dtype=dt, device=dev)
            sc = (spec.kinds, bank, sc_in[1], sc_in[2])
        r = fn(*args, flux, **kw, scoring=sc, deterministic=det,
               tally_seg=seg if segmented else None)
        return r, bank

    (ra, ba), (rp, bp) = run(walk, False), run(walk_plain, False)
    (rd, bd), (rd2, bd2) = run(walk, ws), run(walk, ws)
    rdp, bdp = run(walk_plain, True)
    sync()
    for f in ("elem", "done", "exited", "iters", "x", "s"):
        check_equal(f"{name} {f}", getattr(ra, f), getattr(rp, f))
        check_bitwise(f"{name} deterministic {f} vs plain", getattr(rd, f),
                      getattr(rdp, f))
    err = check_flux(name, ra.flux, rp.flux)
    check_bitwise(f"{name} deterministic flux vs plain", rd.flux, rdp.flux)
    check_bitwise(f"{name} deterministic flux, two launches", rd.flux,
                  rd2.flux)
    if scored:
        check_bank(name, ba, bp, spec.kinds)
        check_bitwise(f"{name} deterministic lanes vs plain", bd, bdp)
        check_bitwise(f"{name} deterministic lanes, two launches", bd, bd2)
    track = (args[5].double() * (rd.x.double() - x.double()).norm(dim=1))
    pad_track = float(track[-1])
    if pad_track <= 0:
        raise AssertionError(f"{name}: the padding row did not walk")
    for k in range(SEG_K):
        for r in (ra, rd):
            check_conservation(f"{name} segment {k}",
                               r.flux[k * E:(k + 1) * E],
                               float(track[k_of == k].sum()))
    turns = in_turns({
        "atomic, segmented": lambda: run(walk, False),
        "deterministic, segmented": lambda: run(walk, ws),
        "atomic, one flux": lambda: run(walk, False, segmented=False),
    }, cuda_ms, passes=DET_PASSES)
    plain_ms = wall_ms(lambda: run(walk_plain, False))
    crossings = count_crossings(functools.partial(advance_mesh, m), x,
                                args[2], args[3],
                                torch.ones_like(args[4], dtype=torch.bool),
                                0, kw["tol"])
    k = x.element_size()
    row_bytes = {"two-tier": 32 + 4 * 5 * k,
                 "row16": unpacked_row_bytes(k, 16),
                 "row20": unpacked_row_bytes(k, 20)}.get(layout, 20 * k)
    # As phase_w0's, plus each particle's offset; the flux bank of SEG_K
    # segments read and written.
    nbytes = n * (11 * k + 15) + E * row_bytes + SEG_K * E * 2 * k
    bound = bound_entry(nbytes, crossings,
                        FLOPS_PER_CROSSING_TWO_TIER if m.two_tier
                        else FLOPS_PER_CROSSING)
    records = det_counts(ws, x)
    print(f"# {name}: atomic x/ids/s bitwise vs plain, flux max abs diff "
          f"{err:.3e}; deterministic bitwise vs plain and across two "
          f"launches ({records[0]} flux records"
          f"{f', {records[1]} lane records' if scored else ''}); each "
          f"segment conserves its sessions' track; the padding row "
          f"(track {pad_track:.4f}) tallied nowhere; in turns (CUDA "
          f"events, ms): "
          + "; ".join(f"{arm} {', '.join(f'{v:.4f}' for v in s)}"
                      for arm, s in turns.items())
          + f"; plain {plain_ms:.3f} ms; {crossings} crossings; bound "
          f"{bound}")
    entry = {"scoring": "walk_scored", "two-tier": "walk_twotier",
             "row16": "walk_unpacked", "row20": "walk_unpacked"}.get(
        layout if m.unpacked else label, "walk")
    return {"name": f"W0 {entry}, segmented commit (tally_seg)",
            "route": "cuda", "source": "pumiumtally_tpu_torch/csrc/walk.cu",
            "replaces": "pumiumtally_tpu/ops/walk.py:470",
            "max_abs_err": err,
            "ms": float(np.median(turns["atomic, segmented"])),
            "det_ms": float(np.median(turns["deterministic, segmented"])),
            "plain_ms": plain_ms, **bound, "library_ms": None,
            "entry": entry}


def phase_block_det(mesh, pts) -> list:
    """W1's and W2's deterministic cells (``det_block_cell``), float32 at
    N and float64 at W0_F64_N. Returns the float32 cells' kernel line
    entries."""
    import torch

    from pumiumtally_tpu_torch import build_box

    box64 = build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                      dtype=torch.float64)
    entries = []
    for m, n in ((mesh, N), (box64, W0_F64_N)):
        for label, kind, scored in DET_BLOCK_CELLS:
            e = det_block_cell(m, label, kind, scored, pts, n)
            if e:
                entries.append(e)
    return entries


def phase_seg(mesh, pts) -> dict:
    """W0's segmented-commit cells (``seg_w0_cell``): packed, two-tier,
    scoring and the two unpacked layouts. Returns the packed cell's
    kernel line entry (the service's fused launches are packed W0
    walks)."""
    cells = [seg_w0_cell(mesh, label, layout, scored, pts)
             for label, layout, scored in SEG_CELLS]
    return cells[0]


# ---------------------------------------------------------------------------
# Phase 15: the multi-session service (service/) with cross-session fusion
# ---------------------------------------------------------------------------

# README's session size; the sessions: SERVICE_MONO plain PumiTally
# sessions (one fusion key), one PumiTally with scoring and a sentinel,
# SERVICE_STREAM StreamingTally sessions in chunks of SERVICE_CHUNK (one
# chunk-wise key) and one default PartitionedPumiTally; SERVICE_BATCHES
# source batches of SERVICE_MOVES continue moves each, on bench.py's
# trajectory (a session and a batch a seed).
SERVICE_N = 100_000
SERVICE_MONO, SERVICE_STREAM = 6, 2
SERVICE_CHUNK = 50_000
SERVICE_BATCHES, SERVICE_MOVES = 3, 2
# The socket front end under tools/loadgen.py: clients, particles each.
LOADGEN_CLIENTS, LOADGEN_N = 32, 10_000


def service_sessions(mesh) -> list:
    """(kind, facade) of the service phase's sessions, on one caller
    mesh (so that each kind's sessions share one fusion key)."""
    from pumiumtally_tpu_torch import (
        PartitionedPumiTally,
        PumiTally,
        ScoringSpec,
        SentinelPolicy,
        StreamingTally,
        TallyConfig,
    )

    cfg = TallyConfig(check_found_all=False)
    out = [("mono", PumiTally(mesh, SERVICE_N, cfg))
           for _ in range(SERVICE_MONO)]
    out.append(("scoring", PumiTally(mesh, SERVICE_N, TallyConfig(
        check_found_all=False, scoring=ScoringSpec(scores=["flux",
                                                          "events"]),
        sentinel=SentinelPolicy()))))
    out += [("stream", StreamingTally(mesh, SERVICE_N,
                                      chunk_size=SERVICE_CHUNK, config=cfg))
            for _ in range(SERVICE_STREAM)]
    out.append(("part", PartitionedPumiTally(mesh, SERVICE_N, cfg)))
    return out


@functools.lru_cache(maxsize=None)
def service_work(i: int) -> list:
    from pumiumtally_tpu_torch.experiments.block_rounds import (
        make_trajectory,
    )

    return [make_trajectory(np.random.default_rng([700 + i, b]), SERVICE_N,
                            SERVICE_MOVES)
            for b in range(SERVICE_BATCHES)]


def drive_service(mesh, fuse: bool) -> tuple:
    """Every session's campaign through one ``TallyService``, queued
    against the stopped worker then run: (each session's flux, positions
    and bank, the fusion telemetry, the fallbacks, the seconds the
    worker spent dispatching moves (fused groups and solo moves, each
    ending in its facades' fence), the group sizes the worker
    launched)."""
    from pumiumtally_tpu_torch import TallyService
    from pumiumtally_tpu_torch.service import fusion, staging

    sizes, move_s = [], []
    real_group, real_op = fusion.run_group, staging.run_op_contained

    def group(items):
        sizes.append(len(items))
        t0 = time.perf_counter()
        out = real_group(items)
        move_s.append(time.perf_counter() - t0)
        return out

    def op(tally, o):
        t0 = time.perf_counter()
        out = real_op(tally, o)
        if o.kind == "move":
            move_s.append(time.perf_counter() - t0)
        return out

    fusion.run_group, staging.run_op_contained = group, op
    try:
        svc = TallyService(autostart=False, fuse_sessions=fuse)
        sessions = service_sessions(mesh)
        handles = [svc.open_session(t, session_id=f"{kind}{i}",
                                    max_queue=SERVICE_BATCHES
                                    * (SERVICE_MOVES + 1))
                   for i, (kind, t) in enumerate(sessions)]
        futs = []
        for b in range(SERVICE_BATCHES):
            for i, h in enumerate(handles):
                work = service_work(i)[b]
                futs.append(h.copy_initial_position(flat(work[0])))
                futs += [h.move(None, flat(d)) for d in work[1:]]
        svc.start()
        for f in futs:
            f.result(timeout=600)
        out = []
        for (kind, t), h in zip(sessions, handles):
            o = {"kind": kind, "flux": h.flux().result(timeout=600),
                 "x": np.asarray(t.positions)}
            if kind == "scoring":
                o["bank"] = h.score_bank().result(timeout=600)
            out.append(o)
        stats, fallbacks = dict(svc.fusion_stats), svc.fusion_fallbacks
        svc.shutdown(drain=False, timeout=600)
    finally:
        fusion.run_group, staging.run_op_contained = real_group, real_op
    return out, stats, fallbacks, sum(move_s), sizes


def fused_group(mesh) -> tuple:
    """The mono group's fused launch on the box: SERVICE_MONO sessions of
    SERVICE_N particles with the deterministic commit armed, their state
    in one slab, one ``move_step_continue`` with the segmented and the
    deterministic commit (``fusion._fused_move``). Returns (the launch,
    the representative session, the sessions)."""
    import torch

    from pumiumtally_tpu_torch.service import fusion

    sessions = [t for kind, t in service_sessions(mesh) if kind == "mono"]
    for i, t in enumerate(sessions):
        t.arm_deterministic()
        t.CopyInitialPosition(flat(service_work(i)[0][0]))
    rep = sessions[0]
    dests = torch.cat([torch.as_tensor(service_work(i)[0][1],
                                       dtype=rep.dtype, device=rep.device)
                       for i in range(len(sessions))])
    n = dests.shape[0]
    fly = torch.ones((n,), dtype=torch.int8, device=rep.device)
    w = torch.ones((n,), dtype=rep.dtype, device=rep.device)
    spans = tuple(t.num_particles for t in sessions)

    def launch():
        return fusion._fused_move(
            rep, [t.x for t in sessions], [t.elem for t in sessions],
            [t.flux for t in sessions], None, None, None, dests, fly, w,
            None, spans=spans, use_committed=(True,) * len(sessions))

    return launch, rep, sessions


def fused_records(rep, sessions) -> tuple:
    """The fused launch's flux record stream, its record count and a
    zeroed [len(sessions) * E] bank."""
    import torch

    rec = rep._deterministic.records(rep.x.device, rep.dtype, "flux", 0)
    bank = torch.zeros((len(sessions) * rep.mesh.nelems,), dtype=rep.dtype,
                       device=rep.device)
    return rec, int(rec.count), bank


def fused_launch_ms(mesh) -> dict:
    """The mono group's fused launch alone (``fused_group``, CUDA events)
    and DC's share: DC alone on that launch's records into the [K*E]
    bank."""
    from pumiumtally_tpu_torch.ops.det_commit import det_commit

    launch, rep, sessions = fused_group(mesh)
    ms = [cuda_ms(launch) for _ in range(DET_PASSES)]
    rec, m, target = fused_records(rep, sessions)
    dc_ms = [cuda_ms(lambda: det_commit(target, rec, m))
             for _ in range(DET_PASSES)]
    return {"ms": ms, "dc_ms": dc_ms, "records": m,
            "sessions": len(sessions)}


def phase_service(mesh, card: str) -> tuple:
    """The multi-session service on the card: the sessions of
    ``service_sessions`` (SERVICE_N particles each) through one
    ``TallyService`` with fusion on, every move of a kind's sessions
    fused (the mono group SERVICE_MONO wide, the streaming group
    SERVICE_STREAM wide, the scoring and the partitioned session alone),
    no fallback; each session bitwise its solo replay (a facade with the
    deterministic commit armed, driven directly), and the whole run
    bitwise the same service with ``fuse_sessions=False``. Launch counts
    are reset before the fused run and read after it. Prints served
    moves/s fused and unfused, dispatches a move, the mono group's fused
    launch alone and DC's share. Then a ``SocketFrontend`` on 127.0.0.1
    under ``tools/loadgen.py`` ``run_load`` (LOADGEN_CLIENTS clients of
    LOADGEN_N particles, the box): every client served, and the first
    two clients' fluxes bitwise their solo replays. Returns the launch
    counts and the fused run's telemetry."""
    from pumiumtally_tpu_torch import kernels

    t0 = time.perf_counter()
    # Unfused first: a first run pays the set-up costs (the partitioned
    # session's first point location) that the second does not.
    unfused, stats_u, _, wall_u, _ = drive_service(mesh, False)
    kernels.reset_launch_counts()
    fused, stats, fallbacks, wall_f, sizes = drive_service(mesh, True)
    counts = {"service": dict(kernels.launch_counts)}
    moves = (SERVICE_MONO + SERVICE_STREAM + 2) * SERVICE_BATCHES \
        * SERVICE_MOVES
    if fallbacks:
        raise AssertionError(f"service: {fallbacks} fused launches fell "
                             "back to solo")
    want_sizes = sorted([SERVICE_MONO, SERVICE_STREAM]
                        * (SERVICE_BATCHES * SERVICE_MOVES))
    got_sizes = sorted(sizes)
    if got_sizes != want_sizes:
        raise AssertionError(f"service: fused group sizes {got_sizes}, "
                             f"expected {want_sizes}")
    fused_moves = (SERVICE_MONO + SERVICE_STREAM) * SERVICE_BATCHES \
        * SERVICE_MOVES
    if stats["fused_moves"] != fused_moves:
        raise AssertionError(f"service: {stats}")
    if stats_u["fused_groups"]:
        raise AssertionError(f"service, fusion off: {stats_u}")
    for i, (a, b) in enumerate(zip(fused, unfused)):
        for k in a:
            if k != "kind" and not np.array_equal(a[k], b[k]):
                raise AssertionError(f"service session {i} ({a['kind']}): "
                                     f"{k} fused differs from unfused")
    for i, (kind, t) in enumerate(service_sessions(mesh)):
        t.arm_deterministic()
        for work in service_work(i):
            t.CopyInitialPosition(flat(work[0]))
            for d in work[1:]:
                t.MoveToNextLocation(None, flat(d))
        for k, v in (("flux", t.flux), ("x", t.positions),
                     ("bank", t.score_bank if kind == "scoring" else None)):
            if v is None:
                continue
            v = v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
            if not np.array_equal(fused[i][k], v):
                raise AssertionError(f"service session {i} ({kind}): {k} "
                                     "differs from its solo replay")
        del t
    dispatches = stats["fused_groups"] + stats["solo_moves"]
    launch = fused_launch_ms(mesh)
    print(f"# service: {len(fused)} sessions of {SERVICE_N} "
          f"({SERVICE_MONO} mono, 1 scoring + sentinel, {SERVICE_STREAM} "
          f"streaming in chunks of {SERVICE_CHUNK}, 1 partitioned), "
          f"{SERVICE_BATCHES} batches of {SERVICE_MOVES} moves: every "
          f"session bitwise its solo replay and the fuse_sessions=False "
          f"run; group sizes {got_sizes}; 0 fallbacks; telemetry {stats}; "
          f"served (the worker's move dispatches, {wall_f:.3f} s fused, "
          f"{wall_u:.3f} s unfused) {moves / wall_f:.1f} moves/s fused "
          f"({moves * SERVICE_N / wall_f / 1e6:.1f} M particle moves/s), "
          f"{moves / wall_u:.1f} unfused "
          f"({moves * SERVICE_N / wall_u / 1e6:.1f} M); "
          f"{dispatches / moves:.3f} dispatches a move fused (unfused 1); "
          f"the mono group's fused launch ({launch['sessions']} x "
          f"{SERVICE_N}) {', '.join(f'{v:.4f}' for v in launch['ms'])} ms, "
          f"DC alone on its {launch['records']} records "
          f"{', '.join(f'{v:.4f}' for v in launch['dc_ms'])} ms (share "
          f"{np.median(launch['dc_ms']) / np.median(launch['ms']):.2f}); "
          f"{card}")
    counts["loadgen"] = phase_loadgen(card)
    print(f"# service phase: {time.perf_counter() - t0:.1f} s")
    return counts, stats


def phase_loadgen(card: str) -> dict:
    """``tools/loadgen.py`` against a ``SocketFrontend`` on 127.0.0.1 on
    the card (the box, float32): every client served with no error, and
    the first two clients' fluxes bitwise their solo replays."""
    import torch

    from pumiumtally_tpu_torch import PumiTally, TallyConfig, build_box
    from pumiumtally_tpu_torch import kernels
    from pumiumtally_tpu_torch.service import SocketFrontend, TallyService

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import loadgen

    box = (1.0, 1.0, 1.0, MESH_DIV, MESH_DIV, MESH_DIV)
    kernels.reset_launch_counts()
    svc = TallyService()
    front = SocketFrontend(svc, host="127.0.0.1")
    front.start()
    try:
        rep = loadgen.run_load(front.host, front.port,
                               clients=LOADGEN_CLIENTS, particles=LOADGEN_N,
                               batches=1, moves=2, mesh_box=box, seed=0,
                               collect_flux=2, timeout=600)
        stats = svc.stats()
    finally:
        front.stop()
        svc.shutdown(drain=False, timeout=600)
    counts = dict(kernels.launch_counts)
    if rep["clients_failed"] or rep["clients_timed_out"] or rep["errors"]:
        raise AssertionError(f"loadgen: {rep['errors'][:3]}")
    mesh = build_box(*box, dtype=torch.float32)
    for row in rep["parity"]:
        t = PumiTally(mesh, LOADGEN_N, TallyConfig(check_found_all=False))
        t.arm_deterministic()
        for src, dests in loadgen.client_campaign(0, row["client"],
                                                  LOADGEN_N, 1, 2):
            t.CopyInitialPosition(src)
            for d in dests:
                t.MoveToNextLocation(None, d, np.ones(LOADGEN_N, np.int8))
        if not np.array_equal(row["flux"],
                              t.flux.cpu().numpy().astype(np.float64)):
            raise AssertionError(f"loadgen client {row['client']}: flux "
                                 "differs from its solo replay")
    print(f"# loadgen ({LOADGEN_CLIENTS} clients x {LOADGEN_N} particles, "
          f"the box, SocketFrontend on 127.0.0.1): served "
          f"{rep['served_moves']} moves, {rep['moves_per_s']:.1f} moves/s, "
          f"latency p50 {rep['latency_ms']['p50']:.2f} ms p99 "
          f"{rep['latency_ms']['p99']:.2f} ms, refusals {rep['refusals']}, "
          f"fusion {stats['fusion']}; clients 0-1 bitwise their solo "
          f"replays; {card}")
    return counts


def main_service() -> int:
    """Phases 1-2 and the service phase alone, with its checks (W0's
    segmented-commit cells first)."""
    import torch

    from pumiumtally_tpu_torch import build_box
    from pumiumtally_tpu_torch.experiments.block_rounds import (
        make_trajectory,
    )

    _, smi = phase_device()
    phase_build()
    mesh = build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                     dtype=torch.float32)
    pts = make_trajectory(np.random.default_rng(0), N, CONTINUE_MOVES + 2)
    phase_seg(mesh, pts)
    counts, _ = phase_service(mesh, smi)
    for key, entry in (("service", "walk"), ("service", "det_commit"),
                       ("service", "walk_scored"),
                       ("service", "gather_block_walk"),
                       ("loadgen", "walk")):
        if counts[key][entry] == 0:
            raise AssertionError(f"{key}: kernel {entry} never launched")
    print(smi)
    return 0


# The block walks' campaigns (phase 14): the partitioned facade's
# sub-split walks W1 and W2 (and W2 with scoring lanes) with a
# CheckpointPolicy, two runs and a mid-batch resume, over the campaign's
# first CAMPAIGN_BLOCK_BATCHES batches and its first CAMPAIGN_BLOCK_N
# particles (cut from CAMPAIGN_BATCHES and N to keep the script's time:
# the brute-force point location of each source batch dominates; the
# resume still lands mid-batch in the second).
CAMPAIGN_BLOCK_BATCHES = 2
CAMPAIGN_BLOCK_N = 250_000
CAMPAIGN_BLOCK_FACADES = {
    "PartitionedPumiTally W1": dict(walk_vmem_max_elems=VMEM_BOUND,
                                    capacity_factor=CAPACITY_FACTOR),
    "PartitionedPumiTally W2": dict(walk_vmem_max_elems=VMEM_BOUND,
                                    capacity_factor=CAPACITY_FACTOR,
                                    walk_kernel="pallas", **BF16),
    "PartitionedPumiTally W2 scoring": dict(
        walk_vmem_max_elems=VMEM_BOUND, capacity_factor=CAPACITY_FACTOR,
        walk_kernel="pallas", **BF16),
}


def phase_block_resilience(mesh, card: str) -> dict:
    """The resilience contract on the sub-split partitioned facades
    (``CAMPAIGN_BLOCK_FACADES``: W1, W2, W2 with scoring lanes), each with
    a ``CheckpointPolicy`` over the campaign: two uninterrupted runs
    bitwise (flux, positions, ids; with scoring the bank too), and a run
    saved mid-batch and resumed into a fresh facade bitwise. Launch
    counts are reset before each first run and read after it."""
    from pumiumtally_tpu_torch import kernels

    work = campaign_inputs()
    counts = {}
    with tempfile.TemporaryDirectory() as d:
        for name in CAMPAIGN_BLOCK_FACADES:
            t0 = time.perf_counter()
            kernels.reset_launch_counts()
            nb = CAMPAIGN_BLOCK_BATCHES
            t = campaign_facade(name, mesh, os.path.join(d, "a", name))
            run_campaign(t, work, batches=nb)
            counts[f"resilience_{name}"] = dict(kernels.launch_counts)
            ref = campaign_state(t)
            del t
            t = campaign_facade(name, mesh, os.path.join(d, "b", name))
            run_campaign(t, work, batches=nb)
            same_state(f"{name}: two runs", campaign_state(t), ref)
            del t
            t = campaign_facade(name, mesh, os.path.join(d, "c", name))
            run_campaign(t, work, stop=(1, 1), batches=nb)
            t.checkpoint_now(tag="mid_batch")
            del t
            t = campaign_facade(name, mesh, os.path.join(d, "c", name))
            t.resume_latest()
            if divmod(t.iter_count, CAMPAIGN_MOVES) != (1, 1):
                raise AssertionError(f"{name}: resumed at iter_count "
                                     f"{t.iter_count}")
            run_campaign(t, work, 1, 1, batches=nb)
            same_state(f"{name}: resumed mid-batch", campaign_state(t), ref)
            del t
            print(f"# resilience {name}: two runs bitwise, resumed "
                  f"mid-batch bitwise"
                  f"{' (flux, positions, ids, bank)' if 'scoring' in name else ''}"
                  f"; {time.perf_counter() - t0:.1f} s; {card}")
    needs = {"PartitionedPumiTally W1": "block_walk",
             "PartitionedPumiTally W2": "twotier_block_walk",
             "PartitionedPumiTally W2 scoring": "twotier_block_walk_scored"}
    for name, entry in needs.items():
        for e in (entry, "det_commit"):
            if counts[f"resilience_{name}"][e] == 0:
                raise AssertionError(f"{name}: kernel {e} never launched: "
                                     f"{counts[f'resilience_{name}']}")
    return counts


def partition_list():
    from pumiumtally_tpu_torch.parallel.partition import walk_local_list

    return walk_local_list


def campaign_facade(name: str, mesh, ckpt_dir=None):
    """``name``'s facade on the box at N particles, with a
    ``CheckpointPolicy`` into ``ckpt_dir`` (None: no policy)."""
    from pumiumtally_tpu_torch import (
        CheckpointPolicy,
        PartitionedPumiTally,
        PumiTally,
        StreamingTally,
        TallyConfig,
    )

    pol = None if ckpt_dir is None else CheckpointPolicy(
        dir=ckpt_dir, every_n_batches=1, keep=3)
    cfg = TallyConfig(check_found_all=False, checkpoint=pol)
    if name in CAMPAIGN_BLOCK_FACADES:
        from pumiumtally_tpu_torch import ScoringSpec

        spec = (ScoringSpec(scores=["flux", "events"])
                if name.endswith("scoring") else None)
        return PartitionedPumiTally(mesh, CAMPAIGN_BLOCK_N, TallyConfig(
            check_found_all=False, checkpoint=pol, scoring=spec,
            **CAMPAIGN_BLOCK_FACADES[name]))
    if name == "StreamingTally":
        return StreamingTally(mesh, N, chunk_size=CAMPAIGN_CHUNK, config=cfg)
    return {"PumiTally": PumiTally,
            "PartitionedPumiTally": PartitionedPumiTally}[name](mesh, N, cfg)


def campaign_inputs() -> list:
    """Each batch's sources and destinations: bench.py's trajectory,
    a batch from its own seed."""
    from pumiumtally_tpu_torch.experiments.block_rounds import (
        make_trajectory,
    )

    return [make_trajectory(np.random.default_rng(100 + b), N,
                            CAMPAIGN_MOVES + 1)
            for b in range(CAMPAIGN_BATCHES)]


def run_campaign(t, work, start_batch: int = 0, done_moves: int = 0,
                 stop=None, batches: int = CAMPAIGN_BATCHES) -> list:
    """Drive the campaign from (start_batch, done_moves) to ``batches``;
    ``stop``: a (batch, moves) after which to return. Returns each move's
    wall ms."""
    moves_ms = []
    for b in range(start_batch, batches):
        skip = done_moves if b == start_batch else 0
        if skip == 0:
            t.CopyInitialPosition(flat(work[b][0]))
        for mv in range(skip, CAMPAIGN_MOVES):
            t0 = time.perf_counter()
            t.MoveToNextLocation(None, flat(work[b][mv + 1]))
            moves_ms.append((time.perf_counter() - t0) * 1e3)
            if stop == (b, mv + 1):
                return moves_ms
    return moves_ms


def campaign_state(t) -> dict:
    out = {"flux": t.flux.cpu().numpy(), "x": np.asarray(t.positions),
           "elem": np.asarray(t.elem_ids)}
    if t._scoring is not None:
        out["bank"] = t.score_bank.cpu().numpy()
    return out


def same_state(what: str, got: dict, want: dict) -> None:
    for k in want:
        if not np.array_equal(got[k], want[k]):
            bad = int((got[k] != want[k]).sum())
            raise AssertionError(f"{what}: {k} differs in {bad} entries")


def campaign_process(facade: str, ckpt_dir: str, out: str,
                     resume: bool) -> None:
    """The campaign of one facade (``all``: each in turn) in this
    process, as ``--resilience-campaign`` runs it: with ``resume`` from
    the newest generation in ``ckpt_dir`` (``<dir>/<facade>``), move by
    move; the final state sealed with ``checkpoint_now`` and written to
    ``out`` (``<out>.<facade>.npz``)."""
    import torch

    from pumiumtally_tpu_torch import build_box

    mesh = build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                     dtype=torch.float32)
    work = campaign_inputs()
    for name in CAMPAIGN_FACADES if facade == "all" else (facade,):
        t = campaign_facade(name, mesh, os.path.join(ckpt_dir, name))
        start = (0, 0)
        if resume:
            info = t.resume_latest()
            if info is not None:
                start = divmod(t.iter_count, CAMPAIGN_MOVES)
                print(f"# {name}: resumed generation {info.generation} at "
                      f"batch {start[0]}", flush=True)
        run_campaign(t, work, *start)
        t.checkpoint_now(final=True)
        np.savez(f"{out}.{name}.npz", **campaign_state(t))
        del t


def campaign_subprocess(facade: str, ckpt_dir: str, out: str,
                        fault=None, resume: bool = False):
    env = {k: v for k, v in os.environ.items() if k != "PUMIUMTALLY_FAULT"}
    if fault:
        env["PUMIUMTALLY_FAULT"] = fault
    cmd = [sys.executable, os.path.abspath(__file__),
           "--resilience-campaign", facade, ckpt_dir, out]
    if resume:
        cmd.append("--resume")
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=CAMPAIGN_TIMEOUT, env=env,
                          cwd=os.path.dirname(os.path.abspath(__file__)))


def phase_resilience(mesh, card: str) -> dict:
    """The resilience contract on the card, on ``PumiTally``,
    ``StreamingTally`` (chunks of CAMPAIGN_CHUNK) and the default
    ``PartitionedPumiTally`` at N particles, each with a
    ``CheckpointPolicy`` (autosave every batch), over the campaign
    (``campaign_inputs``): two uninterrupted runs equal bitwise (flux,
    positions, ids); a run saved mid-batch (``checkpoint_now`` after the
    second batch's first move) and resumed into a fresh facade
    (``resume_latest``) equal to the uninterrupted one bitwise; a drain
    arm in a subprocess (``PUMIUMTALLY_FAULT=sigterm@batch:2``: exit 0
    before the end, then ``--resume``, all three facades in one resuming
    process) equal too. Launch counts are reset before the first run
    and read after it (the kernel line's launches). Prints the seconds
    to save and to resume and a move's wall ms with the policy against
    the same campaign without one. Returns the launch counts a facade."""
    from pumiumtally_tpu_torch import kernels

    work = campaign_inputs()
    counts = {}
    with tempfile.TemporaryDirectory() as d:
        ref = {}
        for name in CAMPAIGN_FACADES:
            kernels.reset_launch_counts()
            t = campaign_facade(name, mesh, os.path.join(d, "a", name))
            ms_armed = run_campaign(t, work)
            counts[f"resilience_{name}"] = dict(kernels.launch_counts)
            ref[name] = campaign_state(t)
            del t
            t = campaign_facade(name, mesh, os.path.join(d, "b", name))
            run_campaign(t, work)
            same_state(f"{name}: two runs", campaign_state(t), ref[name])
            del t
            t = campaign_facade(name, mesh, os.path.join(d, "c", name))
            run_campaign(t, work, stop=(1, 1))
            t0 = time.perf_counter()
            t.checkpoint_now(tag="mid_batch")
            save_s = time.perf_counter() - t0
            del t
            t = campaign_facade(name, mesh, os.path.join(d, "c", name))
            t0 = time.perf_counter()
            info = t.resume_latest()
            resume_s = time.perf_counter() - t0
            if divmod(t.iter_count, CAMPAIGN_MOVES) != (1, 1):
                raise AssertionError(f"{name}: resumed at iter_count "
                                     f"{t.iter_count} (generation "
                                     f"{info.generation})")
            run_campaign(t, work, 1, 1)
            same_state(f"{name}: resumed mid-batch", campaign_state(t),
                       ref[name])
            del t
            t = campaign_facade(name, mesh)
            ms_plain = run_campaign(t, work)
            l1 = float(np.abs(t.flux.cpu().numpy().astype(np.float64)
                              - ref[name]["flux"]).sum()
                       / np.abs(ref[name]["flux"]).sum())
            del t
            print(f"# resilience {name}: two runs bitwise; saved mid-batch "
                  f"in {save_s:.3f} s, resumed in {resume_s:.3f} s, then "
                  f"bitwise; a move's wall ms with the policy "
                  f"{', '.join(f'{v:.2f}' for v in ms_armed)} (median "
                  f"{np.median(ms_armed):.2f}), without "
                  f"{', '.join(f'{v:.2f}' for v in ms_plain)} (median "
                  f"{np.median(ms_plain):.2f}); atomic-commit flux L1 "
                  f"{l1:.3e} of the total; {card}")
        t0 = time.perf_counter()
        out = os.path.join(d, "drain")
        for name in CAMPAIGN_FACADES:
            r = campaign_subprocess(name, os.path.join(d, "drain"), out,
                                    fault="sigterm@batch:2")
            if r.returncode != 0 or os.path.exists(f"{out}.{name}.npz"):
                raise AssertionError(f"{name}: the drain arm exited "
                                     f"{r.returncode}: {r.stderr[-2000:]}")
        r = campaign_subprocess("all", os.path.join(d, "drain"), out,
                                resume=True)
        if r.returncode != 0:
            raise AssertionError(f"the resuming process exited "
                                 f"{r.returncode}: {r.stderr[-2000:]}")
        for name in CAMPAIGN_FACADES:
            if f"# {name}: resumed generation" not in r.stdout:
                raise AssertionError(f"{name}: no resume in {r.stdout}")
            with np.load(f"{out}.{name}.npz") as z:
                same_state(f"{name}: drain arm", dict(z), ref[name])
        print(f"# resilience drain arm (SIGTERM at the second batch close, "
              f"exit 0, then --resume): bitwise on "
              f"{', '.join(CAMPAIGN_FACADES)}; "
              f"{time.perf_counter() - t0:.1f} s of subprocesses")
    needs = {"resilience_PumiTally": "walk",
             "resilience_StreamingTally": "walk",
             "resilience_PartitionedPumiTally": "gather_block_walk"}
    for key, entry in needs.items():
        for e in (entry, "det_commit"):
            if counts[key][e] == 0:
                raise AssertionError(f"{key}: kernel {e} never launched: "
                                     f"{counts[key]}")
    return counts


def main_resilience() -> int:
    """Phases 1-2, the W0 registers check, and phase 14 alone, with its
    checks."""
    import torch

    from pumiumtally_tpu_torch import build_box
    from pumiumtally_tpu_torch.experiments.block_rounds import (
        make_trajectory,
    )

    name, smi = phase_device()
    phase_build()
    phase_scoring_registers()
    mesh = build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                     dtype=torch.float32)
    pts = make_trajectory(np.random.default_rng(0), N, CONTINUE_MOVES + 2)
    entry = phase_det_kernels(mesh, pts)
    phase_dc_cells()
    phase_block_det(mesh, pts)
    counts = phase_resilience(mesh, smi)
    counts.update(phase_block_resilience(mesh, smi))
    entry["launches"] = sum(c["det_commit"] for c in counts.values())
    print(f"# det_commit: {json.dumps(entry)}")
    print(smi)
    return 0


def dc_stats(rec, m: int, K: int, elem_bytes: int) -> dict:
    """The records' shape for DC: the largest bucket (records of one
    key) and, where the checkout's DC has a plan (``dc_plan``), the
    plan's tile width, tiles, key-group shift and stage, and the largest
    tile."""
    import torch

    from pumiumtally_tpu_torch.ops import det_commit as dc

    key = rec.key[:m].long()
    out = {"records": m, "keys": K,
           "largest_bucket": int(torch.bincount(key, minlength=K).max())}
    if hasattr(dc, "dc_plan"):
        plan = dc.dc_plan(m, K, elem_bytes, *dc.device_smem(rec.key.device))
        out.update(tk=plan.tk, tiles=plan.tiles,
                   group_shift=plan.group_shift, stage=plan.stage,
                   largest_tile=int(torch.bincount(key // plan.tk).max()))
    return out


def dc_floor_ms(m: int, K: int, elem_bytes: int) -> float:
    """The redesigned DC's own floor at the card's memory rate: the
    histogram's key reads (4 bytes a record), each split's read and
    write (the stream's key, ord and value, then the partitioned record
    of ``rec_bytes``), the tile commit's read, the target read and
    written."""
    rb = 16 if elem_bytes == 4 else 24
    nbytes = (m * (4 + (12 + elem_bytes + rb) + 2 * rb + rb)
              + 2 * K * elem_bytes)
    return nbytes / HBM_BYTES_PER_S * 1e3


def dc_kernel_ms(fn) -> dict:
    """Device ms of each of DC's kernels (and memsets) in one call of
    ``fn``, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    by = {}
    for e in prof.events():
        if e.name.startswith(("dc_", "void dc_", "Memset")):
            k = re.sub(r"^void |[(].*$", "", e.name)
            by[k] = by.get(k, 0.0) + e.time_range.elapsed_us()
    return {k: round(v / 1e3, 4) for k, v in by.items()}


def dc_regime(label: str, rec, m: int, target, smi: str) -> dict:
    """DC alone on ``m`` records of the stream ``rec`` into a copy of
    ``target``: bitwise against ``det_commit_plain``; its ms (CUDA
    events, DET_PASSES passes), its kernels' ms (torch.profiler,
    DET_PASSES passes), ``index_put_(accumulate=True)`` under
    ``torch.use_deterministic_algorithms(True)`` (nothing in the port
    calls it), the bound (each record read once, the target read and
    written), the redesign's floor (``dc_floor_ms``), the largest bucket
    and tile (``dc_stats``) and the over-full tiles of the commit. One
    JSON line; it calls only what every checkout with DC has."""
    import torch

    from pumiumtally_tpu_torch.ops import det_commit as dc

    got, want = target.clone(), target.clone()
    dc.det_commit(got, rec, m)
    sync()
    overfull = (int(rec.overfull) if hasattr(rec, "overfull") else None)
    dc.det_commit_plain(want, rec.key[:m], rec.ord[:m], rec.val[:m])
    sync()
    check_bitwise(f"DC {label} vs det_commit_plain", got, want)
    scratch = target.clone()
    ms = [cuda_ms(lambda: dc.det_commit(scratch, rec, m))
          for _ in range(DET_PASSES)]
    kms = [dc_kernel_ms(lambda: dc.det_commit(scratch, rec, m))
           for _ in range(DET_PASSES)]
    keys, val = rec.key[:m].long(), rec.val[:m]
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        lib = [cuda_ms(lambda: scratch.index_put_((keys,), val,
                                                  accumulate=True))
               for _ in range(DET_PASSES)]
    finally:
        torch.use_deterministic_algorithms(prev)
    k = target.element_size()
    K = target.numel()
    out = {"dc_times": label, **dc_stats(rec, m, K, k), "overfull": overfull,
           "ms": ms, "ms_by_kernel": kms, "index_put_ms": lib,
           **bound_entry(m * (4 + 8 + k) + 2 * K * k, 0),
           "floor_ms": dc_floor_ms(m, K, k), "card": smi}
    print(json.dumps(out))
    return out


def main_det_times() -> int:
    """Phases 1-2, then DC alone (``dc_regime``) on the records of the
    port's deterministic walks: the box's W0 move at N particles with
    the stride-96 spec (flux and lanes, float32), the lattice's W0 move
    (flux), the service's fused group (its [SERVICE_MONO * E] bank), and
    the box's W0 move in float64 at W0_F64_N; one JSON line a regime, no
    checks beyond DC against ``det_commit_plain`` (bitwise). It calls
    only what the port had before DC's tiled design, so copy it into
    the parent's ``git archive`` for an A/B."""
    import torch

    from pumiumtally_tpu_torch import build_box
    from pumiumtally_tpu_torch.experiments.block_rounds import (
        make_trajectory,
    )
    from pumiumtally_tpu_torch.io.load import load_mesh
    from pumiumtally_tpu_torch.ops.det_commit import DetWorkspace
    from pumiumtally_tpu_torch.ops.walk import walk
    from pumiumtally_tpu_torch.scoring import ScoringRuntime

    _, smi = phase_device()
    phase_build()
    print(f"# package {sys.modules['pumiumtally_tpu_torch'].__file__}")

    def records(ws, x, name):
        rec = ws.records(x.device, x.dtype, name, 0)
        return rec, int(rec.count)

    mesh = build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                     dtype=torch.float32)
    pts = make_trajectory(np.random.default_rng(0), N, CONTINUE_MOVES + 2)
    args, kw = w0_inputs(mesh, pts, False, N)
    m, x = args[:2]
    spec = score_spec()
    rt = ScoringRuntime(spec, m.nelems, x.dtype, x.device)
    sbin, sfac, _ = score_lanes(rt, N, 5)
    flux = torch.zeros((m.nelems,), dtype=x.dtype, device=x.device)
    lanes = torch.zeros((rt.bank_size,), dtype=x.dtype, device=x.device)
    ws = DetWorkspace()
    walk(*args, flux, **kw, deterministic=ws,
         scoring=(spec.kinds, lanes, sbin, sfac))
    for name, target in (("flux", flux), ("lanes", lanes)):
        rec, n = records(ws, x, name)
        dc_regime(f"box W0 {name}", rec, n, torch.zeros_like(target), smi)
    del ws, lanes
    with tempfile.TemporaryDirectory() as d:
        path, lat_pts = write_lattice(d)
        lat = load_mesh(path, dtype=torch.float32)
        args, kw = w0_inputs(lat, lat_pts, False, N)
        ws = DetWorkspace()
        walk(*args, torch.zeros((lat.nelems,), dtype=torch.float32,
                                device=args[1].device), **kw,
             deterministic=ws)
        rec, n = records(ws, args[1], "flux")
        dc_regime("lattice W0 flux", rec, n,
                  torch.zeros((lat.nelems,), dtype=torch.float32,
                              device=args[1].device), smi)
        del ws, lat, args
    launch, rep, sessions = fused_group(mesh)
    launch()
    sync()
    rec, n, bank = fused_records(rep, sessions)
    dc_regime(f"service fused group ({SERVICE_MONO} sessions)", rec, n,
              bank, smi)
    box64 = build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                      dtype=torch.float64)
    args, kw = w0_inputs(box64, pts, False, W0_F64_N)
    ws = DetWorkspace()
    walk(*args, torch.zeros((box64.nelems,), dtype=torch.float64,
                            device=args[1].device), **kw, deterministic=ws)
    rec, n = records(ws, args[1], "flux")
    dc_regime("box W0 flux (float64)", rec, n,
              torch.zeros((box64.nelems,), dtype=torch.float64,
                          device=args[1].device), smi)
    print(smi)
    return 0


def main_resilience_campaign() -> int:
    """``--resilience-campaign FACADE CKPT_DIR OUT [--resume]``: one
    campaign process of phase 14's drain arm."""
    argv = sys.argv[sys.argv.index("--resilience-campaign") + 1:]
    campaign_process(argv[0], argv[1], argv[2], "--resume" in argv)
    return 0


# Phase 16: the C ABI and the CLI. Particles and moves of the in-process
# ABI runs (three two-phase moves, then one continue) and of bench_host
# (6 timed two-phase moves after a warm-up, bench.py's shape); the
# streaming engine's chunk.
NATIVE_N = 500_000
NATIVE_TWO_PHASE_MOVES = 3
NATIVE_CHUNK = 250_000
NATIVE_BENCH_MOVES = 6
# The arms timed on bench_host's protocol: the C host (an embedded
# interpreter), the same loop through ctypes in this process, the Python
# facade here and in a process of its own (``--python-two-phase``).
NATIVE_ARMS = ("bench_host", "ctypes", "python", "python, own process")
# The engines driven through the ABI and the kernel each must launch.
NATIVE_ENGINES = {"mono": "walk", "streaming": "walk",
                  "partitioned": "gather_block_walk",
                  "streaming_partitioned": "gather_block_walk"}
_NATIVE_SIGS = {
    "pumiumtally_create": ("p", ["s", "i32"]),
    "pumiumtally_copy_initial_position": ("i", ["p", "d", "i32"]),
    "pumiumtally_move_to_next_location": (
        "i", ["p", "d", "d", "i8", "d", "i32"]),
    "pumiumtally_move_continue": ("i", ["p", "d", "i8", "d", "i32"]),
    "pumiumtally_get_flux": ("i64", ["p", "d", "i64"]),
    "pumiumtally_get_positions": ("i64", ["p", "d", "i64"]),
    "pumiumtally_get_elem_ids": ("i64", ["p", "i32p", "i64"]),
    "pumiumtally_destroy": (None, ["p"]),
}


def native_library(path: str):
    """The port's C ABI library loaded into this interpreter (ctypes'
    default RTLD_LOCAL), its entry points typed."""
    import ctypes

    t = {"p": ctypes.c_void_p, "s": ctypes.c_char_p, "i": ctypes.c_int,
         "i32": ctypes.c_int32, "i64": ctypes.c_int64,
         "d": ctypes.POINTER(ctypes.c_double),
         "i8": ctypes.POINTER(ctypes.c_int8),
         "i32p": ctypes.POINTER(ctypes.c_int32), None: None}
    lib = ctypes.CDLL(path)
    for name, (res, args) in _NATIVE_SIGS.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = t[res], [t[a] for a in args]
    return lib


def dp(a: np.ndarray):
    """A float64 array's data as the C ABI's ``double*``."""
    import ctypes

    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def native_drive(lib, msh: str, moves: list) -> tuple:
    """Create through the ABI, source, two-phase moves, one continue;
    returns (flux, positions, ids) read back through the accessors."""
    import ctypes

    n = moves[0].shape[0]
    h = lib.pumiumtally_create(msh.encode(), n)
    if not h:
        raise AssertionError("pumiumtally_create returned NULL")
    try:
        bufs = [flat(p) for p in moves]
        if lib.pumiumtally_copy_initial_position(h, dp(bufs[0]), 3 * n):
            raise AssertionError("copy_initial_position failed")
        flying = np.empty(n, np.int8)
        weights = np.ones(n)
        for m in range(1, NATIVE_TWO_PHASE_MOVES + 1):
            flying[:] = 1
            if lib.pumiumtally_move_to_next_location(
                    h, dp(bufs[m - 1]), dp(bufs[m]),
                    flying.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                    dp(weights), 3 * n):
                raise AssertionError(f"move {m} failed")
            if flying.any():
                raise AssertionError("flying[] not zeroed across the ABI")
        if lib.pumiumtally_move_continue(
                h, dp(bufs[-1]), ctypes.POINTER(ctypes.c_int8)(),
                ctypes.POINTER(ctypes.c_double)(), 3 * n):
            raise AssertionError("move_continue failed")
        ne = lib.pumiumtally_get_flux(h, None, 0)
        flux, pos = np.zeros(ne), np.zeros(3 * n)
        ids = np.zeros(n, np.int32)
        if (lib.pumiumtally_get_flux(h, dp(flux), ne) != ne
                or lib.pumiumtally_get_positions(h, dp(pos), 3 * n) != 3 * n
                or lib.pumiumtally_get_elem_ids(
                    h, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    n) != n):
            raise AssertionError("an accessor returned a wrong count")
    finally:
        lib.pumiumtally_destroy(h)
    return flux, pos.reshape(n, 3), ids


def timed_two_phase(drive, fetch, n: int, moves: int) -> tuple:
    """bench_host's timing: a warm-up move and a flux fetch, then
    ``moves`` moves and a fetch. Returns (moves/s, host ms of each timed
    call)."""
    drive(1)
    fetch()
    calls = []
    t0 = time.perf_counter()
    for m in range(2, moves + 2):
        t1 = time.perf_counter()
        drive(m)
        calls.append((time.perf_counter() - t1) * 1e3)
    fetch()
    return n * moves / (time.perf_counter() - t0), calls


def abi_two_phase_rate(lib, msh: str, n: int, moves: int) -> tuple:
    """bench_host's loop through the C ABI from this interpreter
    (ctypes): the boundary's cost without a second process."""
    import ctypes

    gen = trajectory_moves(1, n)
    pts = [flat(next(gen)) for _ in range(moves + 2)]
    flux = np.zeros(MESH_DIV ** 3 * 6)
    h = lib.pumiumtally_create(msh.encode(), n)
    if not h:
        raise AssertionError("pumiumtally_create returned NULL")
    flying, weights = np.empty(n, np.int8), np.ones(n)
    fly = flying.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))

    def drive(m):
        flying[:] = 1
        if lib.pumiumtally_move_to_next_location(
                h, dp(pts[m - 1]), dp(pts[m]), fly, dp(weights), 3 * n):
            raise AssertionError(f"move {m} failed")

    try:
        lib.pumiumtally_copy_initial_position(h, dp(pts[0]), 3 * n)
        return timed_two_phase(
            drive, lambda: lib.pumiumtally_get_flux(h, dp(flux), flux.size),
            n, moves)
    finally:
        lib.pumiumtally_destroy(h)


def is_switch(key: str) -> bool:
    """A PUMIUMTALLY_ engine switch: any such variable but the chip
    lock's, which children inherit."""
    return key.startswith("PUMIUMTALLY_") and key not in CHIP_LOCK_VARS


def native_env(**extra) -> dict:
    """This process's environment without any PUMIUMTALLY_ switch (the
    default engine, device and dtype), plus ``extra``; the chip lock's
    variables stay (the child works inside this run's window)."""
    env = {k: v for k, v in os.environ.items() if not is_switch(k)}
    env.update(extra)
    return env


@contextlib.contextmanager
def timed_moves(inner: list):
    """Append the host ms of every ``PumiTally.MoveToNextLocation`` call
    to ``inner`` while the block runs."""
    from pumiumtally_tpu_torch import PumiTally

    move = PumiTally.MoveToNextLocation

    def timed_move(self, *args, **kw):
        t1 = time.perf_counter()
        try:
            return move(self, *args, **kw)
        finally:
            inner.append((time.perf_counter() - t1) * 1e3)

    PumiTally.MoveToNextLocation = timed_move
    try:
        yield inner
    finally:
        PumiTally.MoveToNextLocation = move


def main_python_two_phase() -> int:
    """Phase 16's arm "python, own process": ``python_two_phase_rate``
    in a fresh process (arguments: mesh, particles, moves); prints
    [moves/s, host ms a call, ms inside the facade] as one JSON line."""
    i = sys.argv.index("--python-two-phase")
    msh, n, moves = sys.argv[i + 1], int(sys.argv[i + 2]), int(sys.argv[i + 3])
    inner = []
    with timed_moves(inner):
        rate, calls = python_two_phase_rate(msh, n, moves)
    print(json.dumps([rate, calls, inner[-moves:]]))
    return 0


def python_two_phase_rate(msh: str, n: int, moves: int) -> tuple:
    """The Python facade on bench_host's protocol (origins echo the
    previous destinations, flying reset each move), on the same
    trajectory shape."""
    from pumiumtally_tpu_torch import PumiTally

    gen = trajectory_moves(1, n)
    pts = [next(gen) for _ in range(moves + 2)]
    t = PumiTally(msh, n)
    t.CopyInitialPosition(flat(pts[0]))
    flying, weights = np.empty(n, np.int8), np.ones(n)

    def drive(m):
        flying[:] = 1
        t.MoveToNextLocation(flat(pts[m - 1]), flat(pts[m]), flying,
                             weights)

    return timed_two_phase(drive, lambda: t.flux.sum().item(), n, moves)


def phase_native(card: str) -> dict:
    """Phase 16: the port's C ABI and CLI on the card. Returns the
    launch counts of each engine driven through the ABI."""
    import torch

    from pumiumtally_tpu_torch import PumiTally, kernels
    from pumiumtally_tpu_torch import cli as port_cli
    from pumiumtally_tpu_torch.api import native
    from pumiumtally_tpu_torch.native import build

    # aot-check compiles every source again into directories of its own;
    # it runs beside the rest of the phase.
    aot = subprocess.Popen(
        [sys.executable, "-m", "pumiumtally_tpu_torch.cli", "aot-check"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": os.path.dirname(
            os.path.abspath(__file__))})
    seconds = build.build_native()
    print(f"# C ABI: built {build.LIBRARY} and {', '.join(build.HOSTS)} in "
          f"{seconds:.2f} s ({build.native_dir().name})")
    lib = native_library(str(build.library_path()))
    counts = {}
    with tempfile.TemporaryDirectory() as d:
        msh, cube = os.path.join(d, "box.msh"), os.path.join(d, "cube.msh")
        port_cli.main(["box", msh, "--nx", str(MESH_DIV), "--ny",
                       str(MESH_DIV), "--nz", str(MESH_DIV)])
        port_cli.main(["box", cube, "--nx", "1", "--ny", "1", "--nz", "1"])
        gen = trajectory_moves(16, NATIVE_N)
        moves = [next(gen) for _ in range(NATIVE_TWO_PHASE_MOVES + 2)]
        expect = sum(float(np.linalg.norm(moves[m] - moves[m - 1],
                                          axis=1).sum())
                     for m in range(1, len(moves)))
        made = []
        create = native.native_create

        def recording_create(*args):
            made.append(create(*args))
            return made[-1]

        native.native_create = recording_create
        saved = {k: os.environ.pop(k) for k in list(os.environ)
                 if is_switch(k)}
        try:
            for engine, entry in NATIVE_ENGINES.items():
                os.environ["PUMIUMTALLY_ENGINE"] = engine
                os.environ["PUMIUMTALLY_CHUNK_SIZE"] = str(NATIVE_CHUNK)
                made.clear()
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                flux, pos, ids = native_drive(lib, msh, moves)
                dt = time.perf_counter() - t0
                counts[f"native_{engine}"] = c = dict(kernels.launch_counts)
                (t,) = made
                if t.device.type != "cuda":
                    raise AssertionError(f"ABI {engine}: the facade runs on "
                                         f"{t.device}")
                if c[entry] == 0:
                    raise AssertionError(f"ABI {engine}: kernel {entry} "
                                         f"never launched: {c}")
                rel = check_conservation(f"ABI {engine}",
                                         torch.from_numpy(flux), expect)
                print(f"# C ABI {engine} ({type(t).__name__} on {t.device}, "
                      f"{t.dtype}): {NATIVE_TWO_PHASE_MOVES} two-phase moves "
                      f"+ 1 continue of {NATIVE_N} particles on "
                      f"{t.mesh.nelems} tets in {dt:.2f} s with its build; "
                      f"conservation rel err {rel:.3e}; launches "
                      f"{ {k: v for k, v in c.items() if v} }")
                del t
                made.clear()
                if engine != "mono":
                    continue
                # The same calls on a PumiTally built directly, in this
                # process: positions and ids bitwise, flux to rtol 1e-4.
                t = PumiTally(msh, NATIVE_N)
                t.CopyInitialPosition(flat(moves[0]))
                for m in range(1, NATIVE_TWO_PHASE_MOVES + 1):
                    t.MoveToNextLocation(flat(moves[m - 1]), flat(moves[m]),
                                         np.ones(NATIVE_N, np.int8),
                                         np.ones(NATIVE_N))
                t.MoveToNextLocation(None, flat(moves[-1]))
                # float32 through the ABI's doubles and back is exact.
                same_bits("ABI mono positions",
                          torch.from_numpy(pos.astype(np.float32)),
                          torch.from_numpy(t.positions))
                check_equal("ABI mono ids", torch.from_numpy(ids),
                            torch.from_numpy(t.elem_ids))
                err = check_flux("ABI mono flux", torch.from_numpy(flux),
                                 t.flux.double().cpu())
                print(f"# C ABI mono vs PumiTally in this process: positions "
                      f"and ids equal, flux max abs diff {err:.3e}")
                del t
        finally:
            native.native_create = create
            for k in [k for k in os.environ if is_switch(k)]:
                del os.environ[k]
            os.environ.update(saved)
        # Embedded: the hosts start their own interpreter, with the
        # default engine and device (no PUMIUMTALLY_ switch but the
        # dtype): a missing GPU would make them fail, never fall back.
        host = str(build.native_dir() / "test_host")
        env = native_env(PUMIUMTALLY_DTYPE="float64")
        r = subprocess.run([host, cube], capture_output=True, text=True,
                           env=env, timeout=600)
        if r.returncode != 0 or "test_host OK" not in r.stdout:
            raise AssertionError(f"test_host failed:\n{r.stdout}\n{r.stderr}")
        if "on cuda" not in r.stderr:
            raise AssertionError(f"test_host: no facade on cuda:\n{r.stderr}")
        bad = subprocess.run([host, cube, "--corrupt"], capture_output=True,
                             text=True, env=env, timeout=600)
        if bad.returncode == 0 or "MISMATCH" not in bad.stderr:
            raise AssertionError("test_host --corrupt did not fail:\n"
                                 f"{bad.stdout}\n{bad.stderr}")
        print(f"# C ABI embedded: test_host (float64, 1e-8 oracle) "
              f"{r.stdout.strip()!r}; {r.stderr.strip().splitlines()[0]}; "
              f"--corrupt exits {bad.returncode} with MISMATCH")
        # The rates are taken with no compile beside them, three arms in
        # turns (C host, ctypes, Python, then the reverse order).
        out, _ = aot.communicate(timeout=1200)
        rates = {arm: [] for arm in NATIVE_ARMS}
        calls = {arm: [] for arm in NATIVE_ARMS[1:]}  # host ms a call
        insides = {arm: [] for arm in NATIVE_ARMS[1:]}  # ms inside the facade
        bench = [str(build.native_dir() / "bench_host"), msh, str(NATIVE_N),
                 str(NATIVE_BENCH_MOVES)]
        fresh = [sys.executable, os.path.abspath(__file__),
                 "--python-two-phase", msh, str(NATIVE_N),
                 str(NATIVE_BENCH_MOVES)]
        for arm in NATIVE_ARMS + NATIVE_ARMS[::-1]:
            if arm in ("bench_host", "python, own process"):
                r = subprocess.run(bench if arm == "bench_host" else fresh,
                                   capture_output=True, text=True,
                                   env=native_env(), timeout=900)
                m = re.search(r"native_two_phase_moves_per_sec=(\d+)",
                              r.stdout)
                if r.returncode != 0 or (arm == "bench_host" and m is None):
                    raise AssertionError(f"{arm} failed:\n{r.stdout}\n"
                                         f"{r.stderr}")
                if m is not None:
                    rates[arm].append(float(m[1]))
                    continue
                rate, ms, inner = json.loads(r.stdout.splitlines()[-1])
            else:
                inner = []
                with timed_moves(inner):
                    rate, ms = (abi_two_phase_rate(lib, msh, NATIVE_N,
                                                   NATIVE_BENCH_MOVES)
                                if arm == "ctypes" else python_two_phase_rate(
                                    msh, NATIVE_N, NATIVE_BENCH_MOVES))
            rates[arm].append(rate)
            calls[arm] += ms
            insides[arm] += inner[-NATIVE_BENCH_MOVES:]
        print(f"# C ABI two-phase moves/s on {card}, "
              f"{NATIVE_BENCH_MOVES} moves of {NATIVE_N} particles on "
              f"{MESH_DIV ** 3 * 6} tets (float32), two passes in turns: "
              + "; ".join(f"{arm} {' '.join(f'{v:.0f}' for v in vals)} "
                          f"({' '.join(f'{NATIVE_N / v * 1e3:.3f}' for v in vals)}"
                          " ms a move)" for arm, vals in rates.items()))
        for arm in calls:
            print(f"# C ABI {arm}: host ms a timed call, median "
                  f"{np.median(calls[arm]):.3f} (range "
                  f"{min(calls[arm]):.3f}-{max(calls[arm]):.3f}); inside "
                  f"MoveToNextLocation median {np.median(insides[arm]):.3f} "
                  f"(range {min(insides[arm]):.3f}-{max(insides[arm]):.3f})")
    print("# CLI aot-check:\n#   " + "\n#   ".join(out.strip().splitlines()))
    if aot.returncode != 0 or "[FAILED]" in out or out.count("[OK]") != 2:
        raise AssertionError(f"aot-check did not report [OK]:\n{out}")
    return counts


# Phase 17: multi-device. One card holds MULTI_SHARDS logical shards of
# a device mesh on cuda:0 (each shard its own tensors, each launching the
# kernels), the card's counterpart of the JAX suite's virtual devices;
# then two processes of two shards each, joined over gloo. Host-bound
# numbers of one card, not a scaling result.
MULTI_SHARDS = 4
# StreamingPartitionedTally with device_groups=2: cut from STREAM_N to
# 2M particles because its point location is brute force (PERF.md §7).
MULTI_STREAM_N = 2_000_000
MULTI_STREAM_CHUNK = 500_000
MULTI_STREAM_GROUPS = 2
# The two-process job's particles (each process builds its partition and
# locates its points; every migration round crosses gloo twice a hop).
MULTI_2P_N = 200_000
MULTI_FLUX_RTOL = 1e-5  # sharded vs one device: the sum order differs
MULTI_TIE_TOL = 1e-5  # a differing id's point lies in both elements
MULTI_PART_ARMS = (
    # (label, knobs, the block walk's entry)
    ("W4", {}, "gather_block_walk"),
    ("W1", dict(walk_vmem_max_elems=VMEM_BOUND,
                capacity_factor=CAPACITY_FACTOR), "block_walk"),
    ("W2", dict(walk_vmem_max_elems=VMEM_BOUND, walk_kernel="pallas",
                capacity_factor=CAPACITY_FACTOR, **BF16),
     "twotier_block_walk"),
)


def shard_mesh(k: int):
    """A mesh of ``k`` logical shards on cuda:0."""
    import torch

    from pumiumtally_tpu_torch.parallel import make_device_mesh

    return make_device_mesh(k, devices=[torch.device("cuda", 0)] * k)


def multi_drive(t, pts, n: int, moves: int = CONTINUE_MOVES) -> list:
    """CopyInitialPosition, one two-phase move, then ``moves`` continue
    moves of n particles; returns each continue move's wall ms."""
    t.CopyInitialPosition(flat(pts[0][:n]))
    t.MoveToNextLocation(flat(pts[0][:n]), flat(pts[1][:n]),
                         np.ones(n, np.int8), np.ones(n))
    return [wall_ms(lambda m=m: t.MoveToNextLocation(None, flat(pts[m][:n])))
            for m in range(2, moves + 2)]


def multi_expect(pts, n: int, moves: int = CONTINUE_MOVES) -> float:
    return sum(float(np.linalg.norm(pts[m][:n] - pts[m - 1][:n],
                                    axis=1).sum())
               for m in range(1, moves + 2))


def check_ties(what: str, mesh, pos, ids_a, ids_b, tol: float) -> int:
    """Ids may differ only where the point lies in both elements (a face
    tie); returns how many differ."""
    bad = np.flatnonzero(ids_a != ids_b)
    if bad.size and not (contains(mesh, pos[bad], ids_a[bad], tol).all()
                         and contains(mesh, pos[bad], ids_b[bad], tol).all()):
        raise AssertionError(f"{what}: {bad.size} ids differ and not all "
                             "are face ties")
    return int(bad.size)


def check_arrays(what: str, got, want) -> None:
    """Two host arrays bitwise equal."""
    if not np.array_equal(got, want):
        raise AssertionError(f"{what}: {int((got != want).sum())} values "
                             "differ")


def check_same_run(what: str, a, b) -> None:
    """Positions, ids and flux bitwise."""
    if not (np.array_equal(a.positions, b.positions)
            and np.array_equal(a.elem_ids, b.elem_ids)
            and bool((a.flux == b.flux).all())):
        raise AssertionError(f"{what}: not bitwise the same run")


def shard_launches(what: str, eng, entry: str) -> list:
    """Each shard's launches of ``entry``; every shard must have one."""
    per = [d.get(entry, 0) for d in eng.shard_launches]
    if min(per) == 0:
        raise AssertionError(f"{what}: a shard never launched {entry}: "
                             f"{per}")
    return per


def profile_engine_move(eng, dests) -> dict:
    """One continue move of ``eng`` under a ``PhaseProfile``: its fenced
    walk, migration, occupancy and bookkeeping ms, rounds and fronts."""
    import torch

    from pumiumtally_tpu_torch.parallel.partition import PhaseProfile

    prof = PhaseProfile()
    d = torch.as_tensor(dests, dtype=torch.float32, device=eng.device)
    ones = torch.ones((d.shape[0],), dtype=torch.float32, device=eng.device)
    wall = wall_ms(lambda: eng.move(None, d, ones.to(torch.int8), ones,
                                    profile=prof))
    keep = ("walk_ms", "migrate_ms", "occupancy_ms", "bookkeeping_ms",
            "rounds", "frontier_max")
    return {"wall_ms": round(wall, 3),
            **{k: round(v, 3) if isinstance(v, float) else v
               for k, v in prof.as_dict().items() if k in keep}}


MIGRATE_REPS = 5  # calls of each migration an arm of the A B B A turns


def capture_migration(eng, dests) -> tuple:
    """The shards' state at the first in-loop migration of one more
    continue move of ``eng`` (cloned), and that round's front."""
    import torch

    got = []
    orig = eng._migrate_round

    def grab(cap_frontier, sts, n_p):
        if not got:
            got.append(([{k: v.clone() for k, v in s.items()} for s in sts],
                        n_p))
        return orig(cap_frontier, sts, n_p)

    eng._migrate_round = grab
    try:
        d = torch.as_tensor(dests, dtype=torch.float32, device=eng.device)
        ones = torch.ones((d.shape[0],), dtype=torch.float32,
                          device=eng.device)
        eng.move(None, d, ones.to(torch.int8), ones)
    finally:
        del eng._migrate_round
    if not got:
        raise AssertionError("the continue move migrated no round")
    return got[0]


def same_states(what: str, a: list, b: list) -> None:
    """Two lists of shard states bitwise equal, row for row."""
    for s, (x, y) in enumerate(zip(a, b)):
        for k in x:
            if not torch_equal(x[k], y[k]):
                raise AssertionError(f"{what}: shard {s} row {k} differs")


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a.cpu(), b.cpu()))


def migrate_times(label: str, eng, dests) -> dict:
    """The two in-process migrations over the shards on one captured
    round (``capture_migration``): ``migrate_shards`` (shard-pair row
    copies) and the collective ring (``make_collective_migrate``), on
    the same shards, MIGRATE_REPS calls each in turns A B B A; both held
    bitwise against each other and, assembled, against the one-device
    ``migrate`` on the assembled state. The frontier pair
    (``frontier_migrate_shards``, ``make_collective_frontier_migrate``)
    likewise, with the smallest power of two that holds the front as the
    slab. Returns the median ms of each."""
    import torch

    from pumiumtally_tpu_torch.parallel.distributed import (
        make_collective_frontier_migrate,
        make_collective_migrate,
    )
    from pumiumtally_tpu_torch.parallel.partition import (
        _frontier_migrate_impl,
        frontier_migrate_shards,
        migrate,
        migrate_shards,
    )

    sts, n_p = capture_migration(eng, dests)
    L, P, cb = eng.part.L, eng.nparts, eng.cap_per_block
    cf = 1 << max(int(n_p) - 1, 0).bit_length()
    kw = dict(part_L=L, nparts=P, cap_per_block=cb, comm=eng.comm)
    arms = {
        "full/shards": lambda: migrate_shards(L, P, cb, sts),
        "full/collective": lambda f=make_collective_migrate(
            eng.device_mesh, **kw): f(sts),
        "frontier/shards": lambda: frontier_migrate_shards(L, P, cb, cf,
                                                           sts),
        "frontier/collective": lambda f=make_collective_frontier_migrate(
            eng.device_mesh, cap_frontier=cf, **kw): f(sts),
    }
    whole = {k: torch.cat([s[k] for s in sts]) for k in sts[0]}
    n_loc = sts[0]["pid"].shape[0]

    def split(st):
        return [{k: v[i * n_loc:(i + 1) * n_loc] for k, v in st.items()}
                for i in range(len(sts))]

    one_full, ovf = migrate(L, P, cb, whole)
    one_front = _frontier_migrate_impl(L, P, cb, cf, whole)
    if ovf or one_front[1]:
        raise AssertionError(f"{label}: the captured round overflows")
    for kind, want in (("full", split(one_full)),
                       ("frontier", split(one_front[0]))):
        for how in ("shards", "collective"):
            res = arms[f"{kind}/{how}"]()
            if res[1]:
                raise AssertionError(f"{label}: {kind}/{how} overflows")
            same_states(f"{label}: {kind}/{how} vs one-device migrate",
                        res[0], want)
    times = {k: [] for k in arms}
    for kind in ("full", "frontier"):
        a, b = f"{kind}/shards", f"{kind}/collective"
        for arm in (a, b, b, a):
            for _ in range(MIGRATE_REPS):
                times[arm].append(wall_ms(arms[arm]))
    med = {k: round(float(np.median(v)), 3) for k, v in times.items()}
    print(f"# {label} migration on {len(sts)} shards, one captured round "
          f"(front {n_p} rows, slab {cf}): both bitwise the one-device "
          f"migrate; median ms of {2 * MIGRATE_REPS} calls each, in turns "
          f"A B B A: {json.dumps(med)}")
    return med


def phase_multi_sharded(mesh, pts, card: str) -> dict:
    """(a) ``PumiTally`` and ``StreamingTally`` sharded over
    MULTI_SHARDS logical shards against the one-device facades on the
    same calls: positions and ids bitwise, flux rtol 1e-5, conservation,
    W0 launched once a shard a walk; under a ``CheckpointPolicy`` two
    runs bitwise (DC)."""
    import torch

    from pumiumtally_tpu_torch import (
        CheckpointPolicy,
        PumiTally,
        StreamingTally,
        TallyConfig,
        kernels,
    )

    counts = {}
    dm = shard_mesh(MULTI_SHARDS)
    expect = multi_expect(pts, N)
    for key, make, walks in (
            ("multi_mono", lambda c: PumiTally(mesh, N, c), 1),
            ("multi_stream", lambda c: StreamingTally(mesh, N, N // 2, c),
             2)):
        runs, ms = {}, {}
        for k, dmk in ((1, None), (MULTI_SHARDS, dm)):
            kernels.reset_launch_counts()
            t = make(TallyConfig(device_mesh=dmk))
            ms[k] = multi_drive(t, pts, N)
            if k > 1:
                counts[key] = dict(kernels.launch_counts)
                kernels.reset_launch_counts()
                t.MoveToNextLocation(None, flat(pts[CONTINUE_MOVES + 2]))
                if kernels.launch_counts["walk"] != MULTI_SHARDS * walks:
                    raise AssertionError(
                        f"{key}: a continue move launched W0 "
                        f"{kernels.launch_counts['walk']} times, want "
                        f"{MULTI_SHARDS * walks}")
                t2 = runs[1]
                t2.MoveToNextLocation(None, flat(pts[CONTINUE_MOVES + 2]))
            runs[k] = t
        one, four = runs[1], runs[MULTI_SHARDS]
        check_arrays(f"{key} positions", four.positions, one.positions)
        check_arrays(f"{key} ids", four.elem_ids, one.elem_ids)
        err = float(((four.flux.double() - one.flux.double()).abs().max()
                     / one.flux.double().abs().max()))
        if err > MULTI_FLUX_RTOL:
            raise AssertionError(f"{key}: flux off by {err:.3e}")
        rel = check_conservation(key, four.flux, multi_expect(
            pts, N, CONTINUE_MOVES + 1))
        print(f"# {key}: {type(four).__name__} on {MULTI_SHARDS} shards of "
              f"cuda:0 vs one device on {card}: positions and ids bitwise, "
              f"flux max rel {err:.3e}, conservation rel err {rel:.3e}; W0 "
              f"{MULTI_SHARDS * walks} launches a walk; ms a continue move "
              f"at {MULTI_SHARDS} shards "
              f"{', '.join(f'{v:.3f}' for v in ms[MULTI_SHARDS])}, at 1 "
              f"{', '.join(f'{v:.3f}' for v in ms[1])}")
        del runs, one, four, t
    del expect
    # The deterministic commit over the shards: two runs, the same bits.
    with tempfile.TemporaryDirectory() as d:
        runs = []
        for r in range(2):
            kernels.reset_launch_counts()
            t = PumiTally(mesh, N, TallyConfig(
                device_mesh=dm, checkpoint=CheckpointPolicy(
                    dir=f"{d}/{r}", handle_signals=False)))
            multi_drive(t, pts, N)
            counts[f"multi_mono_det{r}"] = dict(kernels.launch_counts)
            runs.append(t)
        check_same_run("sharded PumiTally under a CheckpointPolicy", *runs)
    print(f"# multi_mono under a CheckpointPolicy: two {MULTI_SHARDS}-shard "
          f"runs bitwise; DC launches "
          f"{counts['multi_mono_det0']['det_commit']}")
    torch.cuda.empty_cache()
    return counts


def phase_multi_partitioned(mesh, pts, card: str) -> dict:
    """(b) ``PartitionedPumiTally`` over MULTI_SHARDS logical devices in
    three forms (W4 by default, W1, W2) against the one-device engine:
    positions bitwise, ids differing only at face ties, conservation,
    every shard launching its block walk; then, under a
    ``CheckpointPolicy`` (DC), the collective's engine path bitwise the
    row copies and two runs bitwise."""
    import torch

    from pumiumtally_tpu_torch import (
        CheckpointPolicy,
        PartitionedPumiTally,
        TallyConfig,
        kernels,
    )

    counts = {}
    dm = shard_mesh(MULTI_SHARDS)
    expect = multi_expect(pts, N)
    for label, knobs, entry in MULTI_PART_ARMS:
        runs, ms = {}, {}
        for k, dmk in ((1, None), (MULTI_SHARDS, dm)):
            kernels.reset_launch_counts()
            t = PartitionedPumiTally(mesh, N, TallyConfig(
                device_mesh=dmk, check_found_all=False, **knobs))
            ms[k] = multi_drive(t, pts, N)
            if k > 1:
                counts[f"multi_part_{label}"] = dict(kernels.launch_counts)
            check_conservation(f"partitioned {label} ({k} shards)", t.flux,
                               expect)
            runs[k] = t
        one, four = runs[1], runs[MULTI_SHARDS]
        check_arrays(f"partitioned {label} positions", four.positions,
                    one.positions)
        ties = check_ties(f"partitioned {label}", mesh, four.positions,
                          four.elem_ids, one.elem_ids, MULTI_TIE_TOL)
        eng = four.engine
        per = shard_launches(f"partitioned {label}", eng, entry)
        prof = profile_engine_move(eng, pts[CONTINUE_MOVES + 2])
        migrate_times(f"multi_part_{label}", eng, pts[CONTINUE_MOVES + 1])
        print(f"# multi_part_{label}: PartitionedPumiTally on "
              f"{MULTI_SHARDS} shards of cuda:0 ({eng.nparts} blocks, "
              f"{eng.blocks_per_chip} a shard) vs one device "
              f"({one.engine.nparts} blocks) on {card}: positions bitwise, "
              f"{ties} ids differ at face ties, conservation held; "
              f"{entry} launches per shard {per}; ms a continue move at "
              f"{MULTI_SHARDS} shards "
              f"{', '.join(f'{v:.3f}' for v in ms[MULTI_SHARDS])}, at 1 "
              f"{', '.join(f'{v:.3f}' for v in ms[1])}; PhaseProfile of one "
              f"more continue move at {MULTI_SHARDS} shards "
              f"{json.dumps(prof)}, at 1 "
              f"{json.dumps(profile_engine_move(one.engine, pts[CONTINUE_MOVES + 2]))}")
        del runs, one, four, eng, t
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        runs, ms = [], []
        # In turns: row copies, collective, collective, row copies. One
        # process keeps the row copies whatever migrate_collective says;
        # the collective's engine path (its path across processes) is
        # run here by asking the engine for it.
        for r, coll in enumerate((False, True, True, False)):
            kernels.reset_launch_counts()
            t = PartitionedPumiTally(mesh, N, TallyConfig(
                device_mesh=dm, migrate_collective=coll,
                check_found_all=False, checkpoint=CheckpointPolicy(
                    dir=f"{d}/{r}", handle_signals=False)))
            if t.engine._collective_migrate is not None:
                raise AssertionError("one process armed the collective")
            if coll:
                t.engine._ring_in_process = True
                t.engine._build_collective_fns()
            ms.append(multi_drive(t, pts, N))
            counts[f"multi_part_det{r}"] = dict(kernels.launch_counts)
            per = shard_launches("partitioned DC", t.engine, "det_commit")
            runs.append(t)
        check_same_run("partitioned: collective vs row copies under DC",
                       runs[0], runs[1])
        check_same_run("partitioned: two collective runs under DC",
                       runs[1], runs[2])
        check_same_run("partitioned: two row-copy runs under DC",
                       runs[0], runs[3])
    print(f"# multi_part under a CheckpointPolicy: the collective's engine "
          f"path bitwise the row copies, two runs of each bitwise; "
          f"migrate_collective=True keeps the row copies in one process; "
          f"DC launches per shard {per}, W4 per shard "
          f"{[d.get('gather_block_walk', 0) for d in runs[2].engine.shard_launches]}; "
          f"ms a continue move in turns (row copies, collective, "
          f"collective, row copies): "
          f"{'; '.join(', '.join(f'{v:.3f}' for v in m) for m in ms)}")
    del runs
    torch.cuda.empty_cache()
    return counts


def phase_multi_groups(mesh, card: str) -> dict:
    """(c) ``StreamingPartitionedTally`` with device_groups=2 on the
    MULTI_SHARDS-shard mesh: MULTI_STREAM_N particles in chunks of
    MULTI_STREAM_CHUNK, round-robin over two groups of shards, against
    the one-device facade: positions bitwise, ids at face ties,
    conservation, every chunk engine's shards launching W4."""
    import torch

    from pumiumtally_tpu_torch import (
        StreamingPartitionedTally,
        TallyConfig,
        kernels,
    )
    from pumiumtally_tpu_torch.experiments.block_rounds import (
        make_trajectory,
    )

    n = MULTI_STREAM_N
    pts = make_trajectory(np.random.default_rng(5), n, 3)
    counts, runs, ms = {}, {}, {}
    for k, cfg in ((1, TallyConfig(check_found_all=False)),
                   (MULTI_SHARDS, TallyConfig(
                       device_mesh=shard_mesh(MULTI_SHARDS),
                       device_groups=MULTI_STREAM_GROUPS,
                       check_found_all=False))):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        t = StreamingPartitionedTally(mesh, n, MULTI_STREAM_CHUNK, cfg)
        ms[k] = multi_drive(t, pts, n, moves=1)
        ms[k].append((time.perf_counter() - t0) * 1e3)
        if k > 1:
            counts["multi_groups"] = dict(kernels.launch_counts)
        check_conservation(f"device groups ({k})", t.flux,
                           multi_expect(pts, n, 1))
        runs[k] = t
    one, grp = runs[1], runs[MULTI_SHARDS]
    check_arrays("device groups positions", grp.positions, one.positions)
    ties = check_ties("device groups", mesh, grp.positions, grp.elem_ids,
                      one.elem_ids, MULTI_TIE_TOL)
    groups = {id(e.device_mesh) for e in grp.engines}
    per = [shard_launches("device groups", e, "gather_block_walk")
           for e in grp.engines]
    print(f"# multi_groups: StreamingPartitionedTally, {n} particles in "
          f"{grp.nchunks} chunks over {MULTI_STREAM_GROUPS} groups of "
          f"{MULTI_SHARDS // MULTI_STREAM_GROUPS} shards ({len(groups)} "
          f"distinct groups) on {card}: positions bitwise vs one device, "
          f"{ties} ids at face ties, conservation held; W4 launches per "
          f"chunk engine per shard {per}; ms the continue move (then the "
          f"whole drive) at {MULTI_SHARDS} shards "
          f"{', '.join(f'{v:.1f}' for v in ms[MULTI_SHARDS])}, at 1 "
          f"{', '.join(f'{v:.1f}' for v in ms[1])}")
    del runs, one, grp
    torch.cuda.empty_cache()
    return counts


def multi_2p_tally(dm, ckpt_dir: str):
    """Phase 17 (d)'s facade: the partitioned engine over ``dm`` with the
    collective migration, under a CheckpointPolicy (DC)."""
    import torch

    from pumiumtally_tpu_torch import (
        CheckpointPolicy,
        PartitionedPumiTally,
        TallyConfig,
        build_box,
    )

    mesh = build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                     dtype=torch.float32)
    return PartitionedPumiTally(mesh, MULTI_2P_N, TallyConfig(
        device_mesh=dm, migrate_collective=True, check_found_all=False,
        capacity_factor=CAPACITY_FACTOR,
        checkpoint=CheckpointPolicy(dir=ckpt_dir, handle_signals=False)))


def multi_2p_campaign(t) -> dict:
    from pumiumtally_tpu_torch.experiments.block_rounds import (
        make_trajectory,
    )

    pts = make_trajectory(np.random.default_rng(0), N, CONTINUE_MOVES + 2)
    multi_drive(t, pts, MULTI_2P_N, moves=2)
    return {"flux": t.flux.cpu().numpy(), "positions": t.positions,
            "elem_ids": t.elem_ids}


def main_multi_device_rank() -> int:
    """One rank of phase 17 (d): ``--multi-device-rank R PORT OUT``; two
    logical shards on cuda:0, joined to the other rank over gloo."""
    import torch

    from pumiumtally_tpu_torch.parallel.distributed import init_distributed

    i = sys.argv.index("--multi-device-rank")
    rank, port, out = int(sys.argv[i + 1]), int(sys.argv[i + 2]), \
        sys.argv[i + 3]
    dm = init_distributed(f"127.0.0.1:{port}", 2, rank,
                          local_devices=[torch.device("cuda", 0)] * 2)
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as d:
        t = multi_2p_tally(dm, d)
        eng = t.engine
        calls = [0]
        for attr in ("_collective_migrate", "_collective_frontier"):
            fn = getattr(eng, attr)
            if fn is not None:
                def counted(s, fn=fn):
                    calls[0] += 1
                    return fn(s)
                setattr(eng, attr, counted)
        t0 = time.perf_counter()
        res = multi_2p_campaign(t)
        dt = time.perf_counter() - t0
        comm = eng.comm
        print(json.dumps({"rank": rank, "backend": dist.get_backend(),
                          "mesh": [str(x) for x in dm.devices],
                          "ranks": list(dm.ranks),
                          "migrations": calls[0],
                          "host_copies": comm.host_copies,
                          "host_bytes": comm.host_bytes,
                          "host_copies_a_migration":
                              comm.host_copies / max(calls[0], 1),
                          "seconds": dt,
                          "launches": eng.shard_launches}), flush=True)
    if rank == 0:
        np.savez(out, **res)
    dist.destroy_process_group()
    return 0


def phase_multi_two_process(card: str) -> None:
    """(d) Two processes, two logical shards of cuda:0 each, over gloo:
    the partitioned facade with the collective migration under a
    CheckpointPolicy is bitwise the one-process MULTI_SHARDS-shard run;
    the backend and the host copies a migration round made are
    printed."""
    import socket

    with tempfile.TemporaryDirectory() as d:
        ref = multi_2p_campaign(multi_2p_tally(shard_mesh(MULTI_SHARDS),
                                               f"{d}/ref"))
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        out = f"{d}/rank0.npz"
        env = dict(os.environ, PUMIUMTALLY_COORD_TIMEOUT="120")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--multi-device-rank", str(r), str(port), out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"two-process rank {r} exited "
                                     f"{p.returncode}:\n{log[-3000:]}")
        got = np.load(out)
        for k, v in ref.items():
            if not np.array_equal(got[k], v):
                raise AssertionError(f"two processes: {k} differs from the "
                                     "one-process run")
    for log in logs:
        for line in log.splitlines():
            if line.startswith("{"):
                print(f"# two-process rank line: {line}")
    print(f"# multi two-process: 2 ranks x 2 shards of cuda:0 over gloo "
          f"on {card}, {MULTI_2P_N} particles: flux, positions and ids "
          f"bitwise the one-process {MULTI_SHARDS}-shard run")


def phase_multi_device(mesh, pts, card: str) -> dict:
    """Phase 17: (a)-(d); returns the main-path runs' launch counts."""
    t0 = time.perf_counter()
    counts = phase_multi_sharded(mesh, pts, card)
    counts.update(phase_multi_partitioned(mesh, pts, card))
    counts.update(phase_multi_groups(mesh, card))
    phase_multi_two_process(card)
    launches = {e: sum(c.get(e, 0) for c in counts.values())
                for e in ("walk", "block_walk", "twotier_block_walk",
                          "gather_block_walk", "det_commit")}
    print(f"# multi-device launches (W0 walk, W1 block_walk, W2 "
          f"twotier_block_walk, W4 gather_block_walk, DC det_commit): "
          f"{json.dumps(launches)}; phase 17 took "
          f"{time.perf_counter() - t0:.1f} s")
    return counts


MULTI_NEEDS = {"multi_mono": "walk", "multi_stream": "walk",
               "multi_mono_det0": "det_commit", "multi_mono_det1": "det_commit",
               "multi_part_W4": "gather_block_walk",
               "multi_part_W1": "block_walk",
               "multi_part_W2": "twotier_block_walk",
               "multi_part_det0": "det_commit",
               "multi_part_det1": "det_commit",
               "multi_part_det2": "det_commit",
               "multi_part_det3": "det_commit",
               "multi_groups": "gather_block_walk"}


# Phase 18: the edges (utils/profiling.py, the examples, each example at
# its own default size) and the kernels each run must launch.
# Traced moves before a missed W0 kernel fails, and the host time at each
# end of the late padded window (a window can lose its kernels once
# CUPTI's device clock parts from the host's: ROADMAP queue 3).
TRACE_ATTEMPTS = 5
TRACE_PAD_MS = 200.0
OPENMC_RUNS = (("mono", "fast", None), ("mono", "reference", None),
               ("stream", "fast", None), ("stream", "reference", None),
               ("part", "fast", None), ("part", "reference", None),
               ("part", "fast", 200))
EDGES_NEEDS = (("edges_trace", "walk"), ("openmc_mono_fast", "walk"),
               ("openmc_mono_reference", "walk"),
               ("openmc_stream_fast", "walk"),
               ("openmc_stream_reference", "walk"),
               ("openmc_part_fast", "gather_block_walk"),
               ("openmc_part_reference", "gather_block_walk"),
               ("openmc_part_fast_vmem200", "block_walk"),
               ("example_multi_client", "walk"),
               ("example_multi_client", "det_commit"),
               ("example_multichip", "gather_block_walk"))
# The chip lock (utils/chiplock.py): its variables, and how long a run
# waits for another holder before it gives up.
CHIP_LOCK_VARS = ("PUMIUMTALLY_CHIP_LOCK", "PUMIUMTALLY_CHIP_LOCK_HELD")
CHIP_LOCK_WAIT_S = 120


def traced_move(t, dst, pad_ms: float = 0.0) -> dict:
    """One continue move of ``t`` to ``dst`` under
    ``utils.profiling.trace`` into a temporary directory, ``pad_ms`` of
    host time inside the window at each end, timed by ``phase_timer``
    fenced on the flux and by CUDA events recorded around the move. The
    window's device kernels, W0's among them, and W0's start less its
    ``cudaLaunchKernel``'s (us; None where the trace kept no W0)."""
    import glob
    import types

    import torch

    from pumiumtally_tpu_torch import kernels
    from pumiumtally_tpu_torch.utils import phase_timer, trace

    sink = types.SimpleNamespace(move_s=0.0)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    sync()
    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as d:
        with trace(d):
            time.sleep(pad_ms / 1e3)
            with phase_timer(sink, "move_s", fence=t.flux):
                start.record()
                t.MoveToNextLocation(None, flat(dst))
                end.record()
            time.sleep(pad_ms / 1e3)
        counts = dict(kernels.launch_counts)
        files = glob.glob(os.path.join(d, "*.pt.trace.json"))
        if len(files) != 1:
            raise AssertionError(f"trace({d}) wrote {files}")
        size = os.path.getsize(files[0])
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("cat") == "kernel"]
    w0 = [e for e in device if "walk_kernel<" in e.get("name", "")]
    launch = {e["args"].get("correlation"): e["ts"] for e in events
              if e.get("cat") == "cuda_runtime"
              and "LaunchKernel" in e.get("name", "")}
    lag = (w0[0]["ts"] - launch[w0[0]["args"]["correlation"]]
           if w0 and w0[0]["args"].get("correlation") in launch else None)
    return {"counts": counts, "size": size, "events": events,
            "device": device, "w0": w0, "lag_us": lag,
            "fenced_ms": sink.move_s * 1e3,
            "event_ms": start.elapsed_time(end)}


class TracedMoves:
    """A ``PumiTally`` on ``mesh`` at N particles, placed at ``pts[0]``
    and moved to ``pts[1]``, whose ``next`` traces a continue move to
    the trajectory's next point (``traced_move``) and holds the flux to
    the track length so far."""

    def __init__(self, mesh, pts):
        from pumiumtally_tpu_torch import PumiTally, TallyConfig

        self.pts, self.prev = pts, 1
        self.t = PumiTally(mesh, N, TallyConfig(check_found_all=False))
        self.t.CopyInitialPosition(flat(pts[0]))
        self.t.MoveToNextLocation(None, flat(pts[1]))
        self.expect = float(np.linalg.norm(pts[1] - pts[0], axis=1).sum())

    def next(self, pad_ms: float = 0.0) -> dict:
        m = 1 + (self.prev % (len(self.pts) - 1))
        w = traced_move(self.t, self.pts[m], pad_ms)
        self.expect += float(np.linalg.norm(
            self.pts[m] - self.pts[self.prev], axis=1).sum())
        check_conservation("traced move", self.t.flux, self.expect)
        self.prev = m
        return w


def phase_trace(mesh, pts, card: str) -> dict:
    """Phase 18a: one continue move of ``PumiTally`` on the box at N
    particles under ``utils.profiling.trace`` (``traced_move``). The
    Chrome trace must exist and name W0's kernel (``walk_kernel<...>``)
    among its device events (a window that missed it is traced again,
    at most TRACE_ATTEMPTS moves), and the fenced reading must be no
    less than the events' device time; W0's start less its launch in
    that window is printed. Returns the launch counts of the traced
    move. The full run takes it first, before any other torch.profiler
    window of the process: that window starts CUPTI, whose device
    timestamps part from the host's within a minute, and later windows
    can lose some or all of their kernels (ROADMAP queue 3;
    ``phase_trace_late`` reports it)."""
    t0 = time.perf_counter()
    moves = TracedMoves(mesh, pts)
    for attempt in range(TRACE_ATTEMPTS):
        w = moves.next()
        if w["w0"]:
            break
        print(f"# profiler retry: the traced move's window held "
              f"{len(w['device'])} device events and no W0 kernel")
    else:
        raise AssertionError(f"trace: {TRACE_ATTEMPTS} traced moves, no W0 "
                             "kernel among the device events")
    if w["fenced_ms"] < w["event_ms"]:
        raise AssertionError(f"phase_timer read {w['fenced_ms']:.3f} ms, "
                             f"less than the move's {w['event_ms']:.3f} ms "
                             "on the device")
    w0 = w["w0"]
    print(f"# trace: a continue move of the box at {N} particles under "
          f"trace(): one Chrome trace of {w['size']} bytes, "
          f"{len(w['events'])} events, {len(w['device'])} device kernels, "
          f"W0 {w0[0]['name'].split('(')[0]!r} x{len(w0)}, "
          f"{sum(e['dur'] for e in w0) / 1e3:.3f} ms, its start "
          f"{w['lag_us']} us after its launch; phase_timer (fenced on the "
          f"flux) {w['fenced_ms']:.3f} ms >= CUDA events "
          f"{w['event_ms']:.3f} ms; {time.perf_counter() - t0:.1f} s; "
          f"{card}")
    return w["counts"]


def phase_trace_late(mesh, pts, t_start: float, card: str) -> None:
    """After phase 17, late in the process: two traced continue moves as
    ``phase_trace`` takes them, then one with TRACE_PAD_MS of host time
    at each end of the window. Reports what each window kept (W0 or not)
    and, from the padded one, W0's start less its launch, to set beside
    phase_trace's early reading: a late window that keeps no device
    event is a known fault (ROADMAP queue 3), so this phase reads it and
    fails on nothing but a wrong move."""
    moves = TracedMoves(mesh, pts)
    readings = [(label, moves.next(pad)) for label, pad in (
        ("plain window 1", 0.0), ("plain window 2", 0.0),
        (f"padded window ({TRACE_PAD_MS:.0f} ms a side)", TRACE_PAD_MS))]
    print(f"# trace late (process age "
          f"{time.perf_counter() - t_start:.0f} s): " + "; ".join(
              f"{label}: {len(w['device'])} device kernels, W0 "
              f"{'kept' if w['w0'] else 'missing'}"
              + (f", its start {w['lag_us']} us after its launch"
                 if w["lag_us"] is not None else "")
              for label, w in readings) + f"; {card}")


def run_example(main, argv: list) -> tuple:
    """An example's ``main(argv)`` with the launch counts set to 0 just
    before it; (its standard output, the counts just after)."""
    import io

    from pumiumtally_tpu_torch import kernels

    out = io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        main(argv)
    counts = dict(kernels.launch_counts)
    return out.getvalue(), counts, time.perf_counter() - t0


def phase_examples(card: str) -> dict:
    """Phase 18b: the three examples on the card at their default sizes,
    through their ``main`` (each into a directory of its own): every
    openmc_style_driver mode and protocol (float64 conservation at 1e-6,
    its VTK file; in the reference protocol every echoing move deduped)
    and part mode at ``--vmem-bound 200`` (W1); multi_client_service's
    two sessions bitwise their serial runs; multichip_checkpointed_run's
    checkpoint and its .pvtu with one piece a shard. Returns each run's
    launch counts."""
    import torch

    from pumiumtally_tpu_torch.examples import (
        multi_client_service,
        multichip_checkpointed_run,
        openmc_style_driver,
    )

    counts, secs = {}, {}
    with tempfile.TemporaryDirectory() as d:
        for mode, protocol, bound in OPENMC_RUNS:
            key = f"openmc_{mode}_{protocol}" + (f"_vmem{bound}" if bound
                                                 else "")
            out_dir = os.path.join(d, key)
            os.mkdir(out_dir)
            argv = ["--mode", mode, "--protocol", protocol, "--out-dir",
                    out_dir] + (["--vmem-bound", str(bound)] if bound else [])
            text, counts[key], secs[key] = run_example(
                openmc_style_driver.main, argv)
            rel = float(re.search(r"rel err = (\S+)", text)[1])
            name = "fluxresult.pvtu" if mode == "part" else "fluxresult.vtk"
            if not os.path.exists(os.path.join(out_dir, name)):
                raise AssertionError(f"{key}: no {name}")
            moves = openmc_style_driver.BATCHES \
                * openmc_style_driver.STEPS_PER_BATCH
            dedup = (openmc_style_driver.BATCHES
                     * (openmc_style_driver.STEPS_PER_BATCH - 1))
            if protocol == "reference" and (
                    f"origin uploads deduped: {dedup} of {moves} moves"
                    not in text):
                raise AssertionError(f"{key}: {text}")
            label = f"--mode {mode} --protocol {protocol}" + (
                f" --vmem-bound {bound}" if bound else "")
            print(f"# example openmc_style_driver {label}: rel err "
                  f"{rel:.2e}, {sorted(os.listdir(out_dir))}, "
                  f"{secs[key]:.2f} s")
        text, counts["example_multi_client"], secs["multi"] = run_example(
            multi_client_service.main, [])
        if text.count("bitwise vs serial run: True") != 2 or \
                "zero cross-talk" not in text:
            raise AssertionError(f"multi_client_service:\n{text}")
        print("# example multi_client_service: "
              + "; ".join(ln for ln in text.splitlines()
                          if ln.startswith("session "))
              + f"; {secs['multi']:.2f} s")
        out_dir = os.path.join(d, "multichip")
        os.mkdir(out_dir)
        text, counts["example_multichip"], secs["multichip"] = run_example(
            multichip_checkpointed_run.main, ["--out-dir", out_dir])
        files = sorted(os.listdir(out_dir))
        shards = len(multichip_checkpointed_run.shard_devices(
            torch.device("cuda")))
        pieces = [f for f in files if f.endswith(".vtu")]
        if "campaign.npz" not in files or "flux_result.pvtu" not in files \
                or len(pieces) != shards:
            raise AssertionError(f"multichip_checkpointed_run: {files}")
        print(f"# example multichip_checkpointed_run ({shards} shards): "
              f"{files}; {text.splitlines()[0]}; "
              f"{secs['multichip']:.2f} s")
    launches = {k: {e: c for e, c in v.items() if c} for k, v in
                counts.items()}
    print(f"# examples' launches: {json.dumps(launches)}; {card}")
    return counts


def phase_edges(mesh, pts, card: str, traced=None) -> dict:
    """Phase 18: the trace and timer of utils/profiling.py (``traced``:
    the launch counts of ``phase_trace`` where the run took it already),
    then the examples; each run must have launched its kernels
    (EDGES_NEEDS). Returns their runs' launch counts."""
    t0 = time.perf_counter()
    counts = {"edges_trace": (phase_trace(mesh, pts, card) if traced is None
                              else traced)}
    counts.update(phase_examples(card))
    for key, entry in EDGES_NEEDS:
        if counts[key][entry] == 0:
            raise AssertionError(f"{key}: kernel {entry} never launched on "
                                 f"its main path: {counts[key]}")
    print(f"# phase 18: {time.perf_counter() - t0:.1f} s")
    return counts


def report_builds(report, built: dict, every_library: bool) -> None:
    """The ``# builds`` line of a run under ``build_guard`` (``report``;
    the guard itself holds each library to one build): the builds and
    loads it counted. Fails where a library was built after
    ``phase_build`` (``built``: what phase_build built; a cached build
    there lets a later one pass the guard) and, where the run launches
    every library (``every_library``), unless each was loaded."""
    from pumiumtally_tpu_torch import kernels

    late = {k: v - built.get(k, 0) for k, v in report.builds.items()
            if v > built.get(k, 0)}
    print("# builds: " + json.dumps({
        "builds": report.builds, "after_phase_build": late,
        "loads": report.loads}))
    if late:
        raise AssertionError(f"libraries built after phase_build: {late}")
    if every_library and report.loads != {n: 1 for n in kernels.SOURCES}:
        raise AssertionError(f"library loads {report.loads}, expected each "
                             "of kernels.SOURCES once")


def main_edges() -> int:
    """Phases 1-2 and phase 18 (utils/profiling.py and the examples)
    alone, with their checks, under ``build_guard``."""
    import torch

    from pumiumtally_tpu_torch import build_box
    from pumiumtally_tpu_torch.experiments.block_rounds import (
        make_trajectory,
    )
    from pumiumtally_tpu_torch.utils.profiling import build_guard

    t_start = time.perf_counter()
    with build_guard() as builds:
        _, smi = phase_device()
        built = phase_build()
        mesh = build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                         dtype=torch.float32)
        pts = make_trajectory(np.random.default_rng(0), N,
                              CONTINUE_MOVES + 2)
        phase_edges(mesh, pts, smi)
    report_builds(builds, built, every_library=False)
    print(f"# total: {time.perf_counter() - t_start:.1f} s")
    print(smi)
    return 0


@contextlib.contextmanager
def device_window():
    """The chip lock (utils/chiplock.py) for this run, waiting at most
    CHIP_LOCK_WAIT_S for another holder; a run whose lock stays busy
    exits non-zero, naming the lock. A child of a run inherits its
    window (PUMIUMTALLY_CHIP_LOCK_HELD)."""
    from pumiumtally_tpu_torch.utils import chiplock

    with chiplock.chip_lock(timeout_s=CHIP_LOCK_WAIT_S) as held:
        if not held:
            raise SystemExit(f"chip_smoke: the chip lock "
                             f"{chiplock.LOCK_PATH} stayed busy for "
                             f"{CHIP_LOCK_WAIT_S} s")
        yield


def main_multi_device() -> int:
    """Phases 1-2 and phase 17 (multi-device) alone, with their checks."""
    import torch

    from pumiumtally_tpu_torch import build_box
    from pumiumtally_tpu_torch.experiments.block_rounds import (
        make_trajectory,
    )

    _, smi = phase_device()
    phase_build()
    mesh = build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                     dtype=torch.float32)
    pts = make_trajectory(np.random.default_rng(0), N, CONTINUE_MOVES + 3)
    counts = phase_multi_device(mesh, pts, smi)
    for key, entry in MULTI_NEEDS.items():
        if counts[key][entry] == 0:
            raise AssertionError(f"{key}: kernel {entry} never launched: "
                                 f"{counts[key]}")
    print(smi)
    return 0


def main_native() -> int:
    """Phases 1-2 and phase 16 (the C ABI and the CLI) alone, with their
    checks."""
    _, smi = phase_device()
    phase_build()
    phase_plane_loads()
    phase_native(smi)
    print(smi)
    return 0


def full_run() -> tuple:
    """Phases 1-18 and their checks; returns the card's name, its
    nvidia-smi line, the kernels' JSON line, the run's start and what
    phase_build built."""
    import torch

    t_start = time.perf_counter()
    name, smi = phase_device()
    built = phase_build()
    phase_plane_loads()

    from pumiumtally_tpu_torch import (
        PartitionedPumiTally,
        PumiTally,
        TallyConfig,
        build_box,
    )
    from pumiumtally_tpu_torch.io.load import load_mesh

    from pumiumtally_tpu_torch.experiments.block_rounds import (
        make_trajectory,
    )

    torch.manual_seed(0)
    mesh = build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                     dtype=torch.float32)
    pts = make_trajectory(np.random.default_rng(0), N, CONTINUE_MOVES + 2)
    traced = phase_trace(mesh, pts, smi)  # phase 18a: see phase_trace
    w0 = phase_w0(mesh, pts)
    phase_w0_skip(mesh, pts)
    w1, regimes_w1 = phase_block_walk("W1", mesh, pts, VMEM_BOUND)
    w0t = phase_w0(mesh, pts, two_tier=True)
    box64 = build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                      dtype=torch.float64)
    phase_w0(box64, pts, " (float64)", n=W0_F64_N)
    # W0's unpacked entries in the forced layout, float32 and float64.
    wu = phase_w0_unpacked(mesh, pts)
    wu += phase_w0_unpacked(box64, pts, " (float64)", n=W0_F64_N)
    # Its other caller: the two-tier mesh's float32 tier, the planes read
    # in place at stride 5 (the sentinel's rung 2).
    wu += phase_w0_unpacked(mesh, pts, " (plane views)", views=True)
    wu += phase_w0_unpacked(box64, pts, " (plane views, float64)",
                            n=W0_F64_N, views=True)
    del box64
    w2, regimes_w2 = phase_block_walk("W2", mesh, pts, VMEM_BOUND)
    _, regimes_w2g = phase_block_walk("W2", mesh, pts, None, shared=False)
    # W4, the gather block walk: every cell against its plain version.
    mesh64 = build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                       dtype=torch.float64)
    w4 = {label: phase_w4(mesh, pts, mesh64, label, knobs, scoring, f64)
          for label, knobs, scoring, f64 in W4_CELLS}
    del mesh64
    w4_list = phase_w4_list(mesh, pts)
    phase_w4_many_blocks(mesh, pts)
    # The scoring slice's kernels: registers of every instantiation, then
    # W0 (both tiers, and float64) and W2 (both regimes) with the
    # stride-96 spec against their plain versions and their scoring-off
    # runs.
    phase_scoring_registers()
    sw0 = phase_w0_scoring(mesh, pts, "", False)
    sw0t = phase_w0_scoring(mesh, pts, "", True)
    phase_w0_scoring(build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                               dtype=torch.float64), pts, " (float64)",
                     False, n=W0_F64_N)
    sw2 = phase_w2_scoring(mesh, pts, VMEM_BOUND, True)
    phase_w2_scoring(mesh, pts, None, False)
    phase_score_edges(mesh, pts)
    # Which regimes each run can take: a staging launch stages every
    # non-empty share, so only W2's global run reads global rows.
    for label, regimes, ran in (("W1", regimes_w1, (1, 0, 1)),
                                ("W2 (shared)", regimes_w2, (1, 0, 1)),
                                ("W2 (global)", regimes_w2g, (0, 1, 0))):
        if tuple(int(c > 0) for c in regimes) != ran:
            raise AssertionError(f"{label}: CUDA blocks per regime "
                                 f"{regimes.tolist()}, expected the "
                                 f"regimes {ran} to run")
    w3 = phase_w3()
    g1 = phase_g1()
    phase_oracle()
    part_cfg = dict(capacity_factor=CAPACITY_FACTOR,
                    walk_vmem_max_elems=VMEM_BOUND)
    runs = {
        "mono": (PumiTally, TallyConfig(check_found_all=True)),
        "part": (PartitionedPumiTally, TallyConfig(**part_cfg)),
        "mono_bf16": (PumiTally, TallyConfig(**BF16)),
        "part_bf16": (PartitionedPumiTally,
                      TallyConfig(walk_kernel="pallas", **BF16, **part_cfg)),
    }
    counts, fluxes = {}, {}
    for key, (facade, config) in runs.items():
        counts[key], fluxes[key], _ = phase_main_path(facade, mesh, pts,
                                                      config, smi)
    counts.update(phase_partitioned_default(mesh, pts, smi))
    phase_staging(mesh, pts)
    phase_scoring_sync(mesh, pts)
    # The unpacked layout through the main path, the straggler ladder on
    # the four facades' paths, intersection_points.
    counts["unpacked_main"] = phase_unpacked_main_path(mesh, pts, smi)
    counts.update(phase_sentinel(mesh, pts, smi))
    phase_xpoints(mesh, pts, smi)
    counts.update(phase_streaming(mesh, smi))
    # The lattice, loaded from its .osh path as users load a mesh: W0
    # on both tiers against the plain versions, then PumiTally's main
    # path on both tiers.
    with tempfile.TemporaryDirectory() as d:
        path, lat_pts = write_lattice(d)
        lat_mesh = load_mesh(path, dtype=torch.float32)
        lw0 = phase_w0(lat_mesh, lat_pts, " (lattice)")
        lw0t = phase_w0(lat_mesh, lat_pts, " (lattice)", two_tier=True)
        # W4 on the lattice as one block (the default partitioned
        # configuration), LATTICE_PART_N particles.
        w4["lattice"] = phase_w4(lat_mesh, lat_pts, None, "lattice", {},
                                 False, False, n=LATTICE_PART_N)
        for two_tier in (False, True):
            phase_w0_scoring(lat_mesh, lat_pts, " (lattice)", two_tier)
        wu += phase_w0_unpacked(lat_mesh, lat_pts, " (lattice)")
        lat64 = load_mesh(path, dtype=torch.float64)
        wu += phase_w0_unpacked(lat64, lat_pts, " (lattice, float64)",
                                n=W0_F64_N)
        wu += phase_w0_unpacked(lat_mesh, lat_pts,
                                " (lattice, plane views)", views=True)
        wu += phase_w0_unpacked(lat64, lat_pts,
                                " (lattice, plane views, float64)",
                                n=W0_F64_N, views=True)
        del lat64
        print(f"# W0 first move: lattice {lw0['ms']:.3f} ms vs box "
              f"{w0['ms']:.3f} ms; two-tier lattice {lw0t['ms']:.3f} ms vs "
              f"box {w0t['ms']:.3f} ms")
        del lat_mesh
        for key, config in (("lat", TallyConfig(check_found_all=True)),
                            ("lat_bf16", TallyConfig(**BF16))):
            counts[key], fluxes[key], _ = phase_main_path(
                PumiTally, path, lat_pts, config, smi)
        # The partitioned facade's default configuration on the lattice:
        # one W4 block of 984,960 tets, LATTICE_PART_N particles.
        t0 = time.perf_counter()
        counts["lat_part"], _, tp = phase_main_path(
            PartitionedPumiTally, path, lat_pts, TallyConfig(), smi,
            n=LATTICE_PART_N)
        print(f"# lattice, default partitioned facade: {tp.engine.nparts} "
              f"block of {tp.engine.part.L} tets; "
              f"{time.perf_counter() - t0:.1f} s with its point location")
        del tp
        # The scoring slice's main path on the four facades.
        counts.update(phase_scoring_facades(mesh, pts, path, lattice_box(),
                                            smi))
    counts["large"] = phase_large_mesh(smi)
    # The deterministic commit against the plain versions, then the
    # resilience contract through three facades.
    det = phase_det_kernels(mesh, pts)
    phase_dc_cells()
    blk = phase_block_det(mesh, pts)
    counts.update(phase_resilience(mesh, smi))
    counts.update(phase_block_resilience(mesh, smi))
    # The service: W0's segmented commit, then the sessions, fused and
    # not, and the socket front end under the load generator.
    seg = phase_seg(mesh, pts)
    svc_counts, _ = phase_service(mesh, smi)
    counts.update(svc_counts)
    # The C ABI (in this process and from C hosts) and the CLI.
    counts.update(phase_native(smi))
    # Multi-device: logical shards of cuda:0, then two processes.
    counts.update(phase_multi_device(mesh, pts, smi))
    phase_trace_late(mesh, pts, t_start, smi)
    # The edges: utils/profiling.py's trace and timer, the examples.
    counts.update(phase_edges(mesh, pts, smi, traced))
    needs = {"mono": "walk", "part": "block_walk", "mono_bf16": "walk_twotier",
             "part_bf16": "twotier_block_walk", "lat": "walk",
             "lat_bf16": "walk_twotier", "stream": "walk",
             "stream_bf16": "walk_twotier", "stream_part": "block_walk",
             "mono_10m": "walk", "mono_10m_bf16": "walk_twotier",
             "score_mono": "walk_scored",
             "score_mono_bf16": "walk_twotier_scored",
             "score_part": "twotier_block_walk_scored",
             "score_lat": "walk_scored",
             "score_lat_bf16": "walk_twotier_scored",
             "score_stream": "walk_scored",
             "score_stream_part": "twotier_block_walk_scored",
             "part_default": "gather_block_walk",
             "part_gather_bf16": "gather_block_walk_twotier",
             "lat_part": "gather_block_walk",
             "score_part_gather": "gather_block_walk_scored",
             "score_part_gather_bf16": "gather_block_walk_twotier_scored",
             "unpacked_main": "walk_unpacked_scored",
             "ladder_mono": "walk", "ladder_mono_bf16": "walk_unpacked",
             "ladder_part": "gather_block_walk", "ladder_stream": "walk",
             "large": "walk_unpacked",
             "resilience_PumiTally": "det_commit",
             "resilience_StreamingTally": "det_commit",
             "resilience_PartitionedPumiTally": "det_commit",
             "resilience_PartitionedPumiTally W1": "block_walk",
             "resilience_PartitionedPumiTally W2": "twotier_block_walk",
             "resilience_PartitionedPumiTally W2 scoring":
                 "twotier_block_walk_scored",
             "service": "walk", "loadgen": "walk",
             **{f"native_{k}": v for k, v in NATIVE_ENGINES.items()},
             **MULTI_NEEDS}
    # W4's list build: the bf16 reroute's full-migrate rounds; the
    # unpacked main path's localization.
    for key, entry in (*needs.items(),
                       ("part_gather_bf16", "gather_work_list"),
                       ("unpacked_main", "walk_unpacked"),
                       ("service", "det_commit"),
                       ("service", "walk_scored"),
                       ("service", "gather_block_walk"),
                       ("loadgen", "det_commit")):
        if counts[key][entry] == 0:
            raise AssertionError(f"{key}: kernel {entry} never launched on "
                                 f"its main path: {counts[key]}")
    for arm in ("mono", "part"):
        check_tie_band(arm, fluxes[f"{arm}_bf16"], fluxes[arm])
    # On the lattice the bf16 plane offsets (coordinates up to 3.78, an
    # ulp of 2^-6 above 2) are coarse against its 1/60-thick layers, so
    # the select tier misattributes a share of the track length that is
    # not a tie class; the JAX package does the same
    # (tests/test_torch_pincell.py holds the port's two-tier flux to
    # it). Here the two-tier run is held to conservation and W0's
    # two-tier variant to its plain version on this mesh; the L1 is
    # reported.
    check_tie_band("lat", fluxes["lat_bf16"], fluxes["lat"], band=None)
    wu_lines = []
    for e in wu[:2]:  # the box's float32 cells: the main path's shapes
        e = dict(e)
        e["max_abs_err"] = max(c["max_abs_err"] for c in wu
                               if c["entry"] == e["entry"])
        wu_lines.append(e)
    w4_lines = []
    for entry, cell in W4_ENTRIES.items():
        e = dict(w4[cell])
        e["max_abs_err"] = max(c["max_abs_err"] for c in w4.values()
                               if c["entry"] == entry)
        w4_lines.append(e)
    for e, entry in ((w0, "walk"), (w1, "block_walk"), (w0t, "walk_twotier"),
                     (w2, "twotier_block_walk"), (sw0, "walk_scored"),
                     (sw0t, "walk_twotier_scored"),
                     (sw2, "twotier_block_walk_scored"),
                     (det, "det_commit"),
                     *((e, e["entry"]) for e in w4_lines + [w4_list]
                       + wu_lines)):
        e["launches"] = sum(c[entry] for c in counts.values())
    # The deterministic block walks: their entries' launches in the armed
    # campaigns (every tallying round there is a kDet launch); W0's
    # segmented commit: W0's launches in the service's fused run.
    for e in blk:
        e["launches"] = counts["resilience_PartitionedPumiTally " + {
            "block_walk": "W1", "twotier_block_walk": "W2",
            "twotier_block_walk_scored": "W2 scoring"}[e["entry"]]][e["entry"]]
    seg["launches"] = counts["service"]["walk"]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    line = json.dumps({"kernels": [{k: e[k] for k in keys}
                                   for e in (w0, w1, w0t, w2, sw0, sw0t, sw2,
                                             *wu_lines, *w4_lines, w4_list,
                                             det, *blk, seg, w3, *g1)]})
    return name, smi, line, t_start, built


def main() -> int:
    """The full run under ``build_guard`` (each library built at most
    once): no library built after phase_build, each loaded; then the
    kernels' line, the card and the result line."""
    import torch

    from pumiumtally_tpu_torch.utils.profiling import build_guard

    with build_guard() as builds:
        name, smi, line, t_start, built = full_run()
    report_builds(builds, built, every_library=True)
    print(line)
    print(f"# total: {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


# --w0-times' unpacked cells: passes of each arm, in turns, in one
# process.
W0_TIMES_PASSES = 4


def w0_times_line(label: str, arms: dict, args, kw, row_bytes: dict,
                  extra_bytes: dict, passes: int = W0_TIMES_PASSES) -> dict:
    """Time ``arms`` (name -> one call of W0 on ``args``' particles) in
    turns (CUDA events, ``passes`` passes), beside the crossings the
    input needs, each arm's bound (the particles' state read and written
    once, each tet the walk crosses read once at ``row_bytes[arm]`` with
    its flux lane read and written, plus ``extra_bytes[arm]``) and SM
    cycles per crossing; print it as one JSON line and return it."""
    import torch

    from pumiumtally_tpu_torch.ops.walk import advance_mesh

    m, x, elem, dest, fly = args[:5]
    turns = in_turns(arms, cuda_ms, passes=passes)
    seen = torch.zeros((m.nelems,), dtype=torch.bool, device=x.device)
    crossings = count_crossings(functools.partial(advance_mesh, m), x, elem,
                                dest, torch.ones_like(fly, dtype=torch.bool),
                                0, kw["tol"], seen)
    rows, n, k = int(seen.sum()), x.shape[0], x.element_size()
    flops = F32_FLOPS if k == 4 else F64_FLOPS
    sms, hz = sm_clock()
    line = {"cell": label, "dtype": str(x.dtype).removeprefix("torch."),
            "tets": m.nelems, "n": n, "crossings": crossings,
            "tets_crossed": rows, "ms": turns, "bound": {},
            "sm_cycles_per_crossing": {}}
    for arm, t in turns.items():
        nbytes = (n * (11 * k + 11) + rows * (row_bytes[arm] + 2 * k)
                  + extra_bytes.get(arm, 0))
        line["bound"][arm] = bound_entry(nbytes, crossings,
                                         FLOPS_PER_CROSSING, flops)
        line["sm_cycles_per_crossing"][arm] = (
            float(np.median(t)) * 1e-3 * sms * hz / crossings)
    print(json.dumps(line))
    return line


def w0_unpacked_cells(label: str, coords, tets, pts) -> None:
    """--w0-times' unpacked cells on one mesh, float32 (N particles) and
    float64 (W0_F64_N): W0 on the packed table, on the unpacked layout
    (``TetMesh.from_arrays(force_unpacked=True)``) and on the two-tier
    tables walked at ``table_dtype="float32"`` (the refinement tier in
    place), in turns; in float32 also the packed and unpacked scoring
    entries with the stride-96 spec. It calls only what every checkout
    with the unpacked layout has."""
    import torch

    from pumiumtally_tpu_torch.mesh.tetmesh import TetMesh
    from pumiumtally_tpu_torch.ops.walk import walk
    from pumiumtally_tpu_torch.scoring import ScoringRuntime

    dev = torch.device("cuda", 0)
    for dtype, n in ((torch.float32, N), (torch.float64, W0_F64_N)):
        def build(**knobs):
            return TetMesh.from_arrays(coords, tets, dtype=dtype,
                                       **knobs).to(device=dev)

        packed, row16 = build(), build(force_unpacked=True)
        lo = build(table_dtype="bfloat16")
        args, kw = w0_inputs(packed, pts, n=n)
        flux = torch.zeros((packed.nelems,), dtype=dtype, device=dev)

        def arm(mesh, tier=None, sc=None):
            return lambda: walk(mesh, *args[1:], flux, **kw,
                                table_dtype=tier, scoring=sc)

        k = torch.finfo(dtype).bits // 8
        arms = {"packed": arm(packed), "row16": arm(row16),
                "row20": arm(lo, "float32")}
        row_bytes = {"packed": 20 * k, "row16": 16 * k + 16,
                     "row20": 20 * k}
        extra = {}
        if dtype == torch.float32:
            spec = score_spec()
            rt = ScoringRuntime(spec, packed.nelems, dtype, dev)
            sbin, sfac, _ = score_lanes(rt, n, 5)
            bank = torch.zeros((rt.bank_size,), dtype=dtype, device=dev)
            sc = (spec.kinds, bank, sbin, sfac)
            arm(packed, sc=sc)()
            lanes = bank_bytes(bank, k) + n * (4 + spec.n_scores * k)
            for a, mesh in (("packed", packed), ("row16", row16)):
                arms[f"{a}_scored"] = arm(mesh, sc=sc)
                row_bytes[f"{a}_scored"] = row_bytes[a]
                extra[f"{a}_scored"] = lanes
        w0_times_line(label, arms, args, kw, row_bytes, extra)


def w0_large_cell(passes: int = W0_TIMES_PASSES) -> dict:
    """--w0-times' and phase 12b's cell: W0 on the continue walk of
    ``PumiTally`` on the 17,179,728-tet box (float32: the unpacked layout
    with no flag), N particles after a two-phase move, timed (CUDA
    events, ``passes`` passes) on the facade's mesh and on its planes
    copied into two contiguous arrays; its line (``w0_times_line``)."""
    import torch

    from pumiumtally_tpu_torch import PumiTally, TallyConfig
    from pumiumtally_tpu_torch.experiments.block_rounds import (
        make_trajectory,
    )
    from pumiumtally_tpu_torch.mesh.box import box_arrays
    from pumiumtally_tpu_torch.mesh.tetmesh import TetMesh

    coords, tets = box_arrays(1, 1, 1, LARGE_DIV, LARGE_DIV, LARGE_DIV)
    t = PumiTally(TetMesh.from_arrays(coords, tets, dtype=torch.float32), N,
                  TallyConfig(check_found_all=False))
    del coords, tets
    pts = make_trajectory(np.random.default_rng(0), N,
                          LARGE_CONTINUE_MOVES + 2)
    t.CopyInitialPosition(flat(pts[0]))
    t.MoveToNextLocation(flat(pts[0]), flat(pts[1]), np.ones(N, np.int8),
                         np.ones(N))
    args, kw = large_continue_walk(t, pts[2])
    return large_walk_times(args, kw, passes)


def large_continue_walk(t, dest) -> tuple:
    """The walk of ``t``'s next continue move to ``dest`` (a ``PumiTally``
    on the large box): the ``walk`` wrapper's positional arguments (flux
    left out) and its keywords."""
    import torch

    dt, dev, n = t.dtype, t.device, t.num_particles
    args = (t.mesh, t.x, t.elem, torch.as_tensor(dest, dtype=dt, device=dev),
            torch.ones((n,), dtype=torch.int8, device=dev),
            torch.ones((n,), dtype=dt, device=dev))
    return args, dict(tally=True, tol=t._tol, max_iters=t._max_iters)


def large_walk_times(args, kw, passes: int) -> dict:
    """W0 on the large box's continue walk ``args``, timed (CUDA events,
    ``passes`` passes into a standing flux); the line of
    ``w0_times_line``."""
    import torch

    from pumiumtally_tpu_torch.ops.walk import walk

    flux = torch.zeros((args[0].nelems,), dtype=args[1].dtype,
                       device=args[1].device)
    k = args[1].element_size()
    return w0_times_line("large box",
                         {"unpacked": lambda: walk(*args, flux, **kw)},
                         args, kw, {"unpacked": 16 * k + 16}, {}, passes)


def main_w0_times() -> int:
    import torch

    from pumiumtally_tpu_torch import build_box
    from pumiumtally_tpu_torch.experiments.block_rounds import (
        make_trajectory,
    )
    from pumiumtally_tpu_torch.io.load import load_mesh

    phase_device()
    phase_build()
    sms, hz = sm_clock()
    print(f"# {sms} SMs at up to {hz / 1e9:.3f} GHz; package "
          f"{sys.modules['pumiumtally_tpu_torch'].__file__}")
    box = build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                    dtype=torch.float32)
    pts = make_trajectory(np.random.default_rng(0), N, CONTINUE_MOVES + 2)
    with tempfile.TemporaryDirectory() as d:
        path, lat_pts = write_lattice(d)
        lattice = load_mesh(path, dtype=torch.float32)
        for label, mesh, p in (("box", box, pts),
                               ("lattice", lattice, lat_pts)):
            for two_tier in (False, True):
                times = w0_times(*w0_inputs(mesh, p, two_tier))
                print(json.dumps({"mesh": label, "two_tier": two_tier,
                                  "tets": mesh.nelems, "n": N, **times}))
        del lattice
    from pumiumtally_tpu_torch.mesh.box import box_arrays
    from pumiumtally_tpu_torch.mesh.pincell import (
        FLAGSHIP_PINCELL,
        lattice_arrays,
    )

    w0_unpacked_cells("box", *box_arrays(1, 1, 1, MESH_DIV, MESH_DIV,
                                         MESH_DIV), pts)
    coords, tets, _, _ = lattice_arrays(*LATTICE, **dict(FLAGSHIP_PINCELL,
                                                         nz=LATTICE_NZ))
    w0_unpacked_cells("lattice", coords, tets, lat_pts)
    w0_large_cell()
    return 0


def w4_sorted_list(eng, st) -> tuple:
    """The element-order arm's work list from torch ops: ``st``'s
    not-done slots ordered by element (block * L + lelem), stably, by a
    sort of int32 keys over every slot, and their count."""
    import torch

    slot = torch.arange(eng.cap, device=st["x"].device)
    key = ((slot // eng.cap_per_block) * eng.part.L
           + st["lelem"]).to(torch.int32)
    key = torch.where(st["done"], torch.full_like(key, 2**31 - 1), key)
    order = torch.sort(key, stable=True).indices.to(torch.int32)
    return order, (~st["done"]).sum(dtype=torch.int32).view(1)


def w4_times_cell(label: str, mesh, pts, n: int, knobs: dict,
                  scoring: bool, tally: bool, arms: bool) -> None:
    """``--w4-times``: one JSON line of W4's round-1 times on one block
    as the engine's round runs it (``w4_call``; W4_PASSES passes; W4's
    kernels, the walk alone, and every device activity of the call)
    beside the bound; with ``arms``, where the checkout has
    ``walk_local_list``, a line for each arm of the first round's
    list (``w4_first_arms``)."""
    import torch

    from pumiumtally_tpu_torch.parallel import partition

    spec = score_spec() if scoring else None
    eng, _, st = w4_engine(mesh, pts, n, spec=spec, **knobs)
    flux = torch.zeros_like(eng.flux_padded) if tally else None
    bank = None if spec is None else torch.zeros_like(eng.score_padded)
    sc = None if bank is None else (spec.kinds, bank, st["sbin"], st["sfac"])
    call = w4_call(eng, st, True, flux, sc, tally)
    want = call()
    crossings, rows = w4_work(eng, st, None)
    nbytes = w4_bytes(eng, st, None, rows, spec, bank)
    flops = ((FLOPS_PER_CROSSING_TWO_TIER if eng.two_tier
              else FLOPS_PER_CROSSING) + (3 if scoring else 0))
    bound = bound_entry(nbytes, crossings, flops)
    on, every, walk = [], [], []
    for _ in range(W4_PASSES):
        t = w4_profile(call)
        on.append(t[0])
        every.append(t[1])
        walk.append(t[2])
    head = {"cell": label, "tets": mesh.nelems, "n": n, "blocks": eng.nparts,
            "slots": eng.cap, "listed": int((~st["done"]).sum()),
            "crossings": crossings, **bound}
    print(json.dumps({**head, "arm": "engine round", "ms": on,
                      "walk_ms": walk, "call_ms": every}))
    if arms and hasattr(partition, "walk_local_list"):
        w4_first_arms(head, eng, st, flux, sc, tally, want)


def w4_first_arms(head: dict, eng, st, flux, sc, tally: bool,
                  want) -> None:
    """``--w4-times``: the arms of a phase's first-round list on the
    round input ``st``, one JSON line each (``head`` and the arm): no
    list (as the engine runs it), or the element order from
    ``w4_sorted_list``; W4 over it in place on copies that each call
    restores first, equal to ``want``, the engine call's result; the
    walk and the list's build timed apart, W4_PASSES passes, the arms in
    turns. Then the walk over an empty list of the slot count's
    capacity: what the CUDA blocks past a list's length cost, which
    every later round pays."""
    import torch

    from pumiumtally_tpu_torch.parallel import partition

    rows = {k: st[k].clone() for k in partition.WALKED_ROWS}
    kw = dict(tally=tally, tol=eng.tol, max_iters=eng.max_iters,
              blocks=eng.nparts, adj_int=eng.part.adj_int,
              table_hi=eng.part.table_hi, scoring=sc)

    def walk(wl):
        for k, v in rows.items():
            v.copy_(st[k])
        return partition.walk_local_list(
            eng.part.table, *(rows.get(k, st[k]) for k in W4_KEYS), flux,
            wl, **kw)

    arms = {"no list": lambda eng, st: None,
            "element order, sort": w4_sorted_list}
    times = {arm: {"walk_ms": [], "build_ms": []} for arm in arms}
    for arm, build in arms.items():
        got = walk(build(eng, st))
        for i, f in enumerate(("x", "lelem", "done", "exited", "pending")):
            check_equal(f"W4 times {head['cell']} {arm} {f}", got[i],
                        want[i])
    for _ in range(W4_PASSES):
        for arm, build in arms.items():
            wl = build(eng, st)
            times[arm]["walk_ms"].append(w4_profile(lambda: walk(wl))[2])
            times[arm]["build_ms"].append(0.0 if wl is None else device_us(
                lambda: build(eng, st), reps=5) / 1e3)
    for arm, t in times.items():
        print(json.dumps({**head, "arm": arm,
                          "ms": [a + b for a, b in zip(t["walk_ms"],
                                                       t["build_ms"])],
                          **t}))
    dev = st["x"].device
    empty = (torch.zeros((eng.cap,), dtype=torch.int32, device=dev),
             torch.zeros((1,), dtype=torch.int32, device=dev))
    print(json.dumps({**head, "arm": "empty list", "capacity": eng.cap,
                      "walk_ms": [w4_profile(lambda: walk(empty))[2]
                                  for _ in range(W4_PASSES)]}))


def w4_subsplit_times(mesh, pts) -> None:
    """``--w4-times``: the gather sub-split's first move (47 blocks),
    each round run as the engine runs it (``w4_call``), its input
    migrated by the engine's ``_migrate`` from the round's output: one
    JSON line each for rounds 1 and 2 and the whole move, W4's kernels
    and the walk alone over W4_PASSES passes, beside the bound."""
    import torch

    from pumiumtally_tpu_torch.parallel import partition

    eng, _, st = w4_engine(mesh, pts, N, **W4_SUBSPLIT)
    n_act = partition._occupancy_counts(st["done"], eng.nparts)
    fns, move_bound = [], 0.0
    for r in range(1, eng.max_rounds + 1):
        ids = (n_act > 0).nonzero().squeeze(1).to(torch.int32)
        call = w4_call(eng, st, r == 1, torch.zeros_like(eng.flux_padded),
                       None)
        res = call()
        fns.append(call)
        if r == 1 and hasattr(partition, "walk_local_list"):
            w4_first_arms({"cell": "sub-split round 1"}, eng, st,
                          torch.zeros_like(eng.flux_padded), None, True, res)
        crossings, rows = w4_work(eng, st, ids)
        bound = bound_entry(w4_bytes(eng, st, ids, rows), crossings)
        move_bound += bound["bound_ms"]
        if r <= 2:
            t = [w4_profile(call) for _ in range(W4_PASSES)]
            print(json.dumps({"cell": f"sub-split round {r}",
                              "blocks": eng.nparts,
                              "listed_blocks": int(ids.numel()),
                              "listed": int((~st["done"]).sum()),
                              "crossings": crossings, **bound,
                              "ms": [v[0] for v in t],
                              "walk_ms": [v[2] for v in t]}))
        if not bool((res[4] >= 0).any()):
            break
        st = eng._migrate(dict(st, x=res[0], lelem=res[1], done=res[2],
                               exited=res[3], pending=res[4]))
        n_act = partition._occupancy_counts(st["done"], eng.nparts)
    t = [w4_profile(lambda: [f() for f in fns], len(fns), reps=1)
         for _ in range(W4_PASSES)]
    print(json.dumps({"cell": "sub-split move", "rounds": len(fns),
                      "bound_ms": move_bound, "ms": [v[0] for v in t],
                      "walk_ms": [v[2] for v in t]}))


def main_w4_times() -> int:
    import torch

    from pumiumtally_tpu_torch import build_box
    from pumiumtally_tpu_torch.experiments.block_rounds import (
        make_trajectory,
    )
    from pumiumtally_tpu_torch.io.load import load_mesh

    phase_device()
    phase_build()
    print(f"# package {sys.modules['pumiumtally_tpu_torch'].__file__}")
    box = build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                    dtype=torch.float32)
    pts = make_trajectory(np.random.default_rng(0), N, CONTINUE_MOVES + 2)
    for label, knobs, scoring, tally, arms in (
            ("box", {}, False, True, True),
            ("box, untallied", {}, False, False, False),
            ("box, two-tier", dict(table_dtype="bfloat16"), False, True,
             True),
            ("box, scoring", {}, True, True, True)):
        w4_times_cell(label, box, pts, N, knobs, scoring, tally, arms)
    w4_subsplit_times(box, pts)
    with tempfile.TemporaryDirectory() as d:
        path, lat_pts = write_lattice(d)
        lattice = load_mesh(path, dtype=torch.float32)
        w4_times_cell("lattice", lattice, lat_pts, LATTICE_PART_N, {},
                      False, True, True)
    return 0


def padded_bins(spec, rt, sbin, rows: int) -> tuple:
    """The padded layout's bank and bin offsets (``--scoring-times``' third
    arm, not the port's layout): every bin's S <= 3 lanes in a 16-byte
    quad, stride 4B and bin offset 4b, ``rows`` rows of the bank; a DROP
    sentinel stays past the bank."""
    import torch

    size = rows * spec.n_bins * 4
    sbin4 = torch.where(sbin < rt.bank_size, sbin // spec.n_scores * 4,
                        torch.full_like(sbin, size))
    return torch.zeros((size,), dtype=rt.dtype, device=rt.device), sbin4


def w0_score_times(mesh, pts, two_tier: bool) -> dict:
    """W0 on the first move at N particles with the stride-96 spec, into
    standing buffers, by CUDA events: scoring off, on, and on with the
    padded layout."""
    import torch

    from pumiumtally_tpu_torch.ops.walk import walk
    from pumiumtally_tpu_torch.scoring import ScoringRuntime

    args, kw = w0_inputs(mesh, pts, two_tier)
    m, x = args[:2]
    spec = score_spec()
    rt = ScoringRuntime(spec, m.nelems, x.dtype, x.device)
    sbin, sfac, _ = score_lanes(rt, N, 5)
    bank4, sbin4 = padded_bins(spec, rt, sbin, m.nelems)
    flux = torch.zeros((m.nelems,), dtype=x.dtype, device=x.device)
    bank = rt.zero_bank()
    times = in_turns({
        "off": lambda: walk(*args, flux, **kw),
        "on": lambda: walk(*args, flux, **kw,
                           scoring=(spec.kinds, bank, sbin, sfac)),
        "padded": lambda: walk(*args, flux, **kw,
                               scoring=(spec.kinds, bank4, sbin4, sfac)),
    }, cuda_ms)
    return {f"{k}_ms": v for k, v in times.items()}


def w2_score_times(mesh, pts, bound) -> list:
    """W2's rounds 1 and 2 of the first move (one round in the global
    regime, ``bound`` None) with the stride-96 spec, into standing
    buffers, by torch.profiler: scoring off, on, and on with the padded
    layout; one dict a round."""
    import torch

    from pumiumtally_tpu_torch.ops.pallas_walk import pallas_walk_local

    spec = score_spec()
    eng, rt, tables, kw, st = w2_score_state(mesh, pts, bound, spec)
    rows = eng.nparts * eng.part.L
    us = functools.partial(device_us, reps=5,
                           name="twotier_block_walk_kernel")
    out = []
    for r in (1, 2):
        flux = torch.zeros_like(eng.flux_padded)
        bank = torch.zeros_like(eng.score_padded)
        bank4, sbin4 = padded_bins(spec, rt, st["sbin"], rows)

        def call(sc, st=st):
            return pallas_walk_local(
                *tables, st["x"], st["lelem"], st["dest"], st["fly"],
                st["w"], st["done"], st["exited"], flux, **kw, scoring=sc)

        times = in_turns({
            "off": lambda: call(None),
            "on": lambda: call((spec.kinds, bank, st["sbin"], st["sfac"])),
            "padded": lambda: call((spec.kinds, bank4, sbin4, st["sfac"])),
        }, lambda fn: us(fn) / 1e3)
        out.append({"round": r, "active": int((~st["done"]).sum()),
                    **{f"{k}_ms": v for k, v in times.items()}})
        res = call((spec.kinds, torch.zeros_like(bank), st["sbin"],
                    st["sfac"]))
        if not bool((res[4] >= 0).any()):
            break
        st = eng._migrate(dict(st, x=res[0], lelem=res[1], done=res[2],
                               exited=res[3], pending=res[4]))
    return out


def main_scoring_times() -> int:
    """``--scoring-times``: the scoring commit's times alone, no checks.
    W0 on both tiers on the box and the lattice, W2's rounds 1-2 (shared
    regime) and its global regime, each scoring off, on (the port's
    layout) and on with the padded layout, SCORE_PASSES passes in turns;
    one JSON line a cell. It calls only what every checkout of the port
    with scoring has (``w0_inputs``, ``walk(scoring=)``,
    ``PartitionedPumiTally`` with a spec, ``pallas_walk_local(scoring=)``,
    the engine's ``_by_pid`` and ``_migrate``), so a copy of this file
    times another checkout."""
    import torch

    from pumiumtally_tpu_torch import build_box
    from pumiumtally_tpu_torch.experiments.block_rounds import (
        make_trajectory,
    )
    from pumiumtally_tpu_torch.io.load import load_mesh

    phase_device()
    phase_build()
    print(f"# package {sys.modules['pumiumtally_tpu_torch'].__file__}")
    box = build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                    dtype=torch.float32)
    pts = make_trajectory(np.random.default_rng(0), N, CONTINUE_MOVES + 2)
    for bound, regime in ((VMEM_BOUND, "shared"), (None, "global")):
        for row in w2_score_times(box, pts, bound):
            print(json.dumps({"kernel": "W2", "regime": regime, **row}))
    with tempfile.TemporaryDirectory() as d:
        path, lat_pts = write_lattice(d)
        lattice = load_mesh(path, dtype=torch.float32)
        for label, mesh, p in (("box", box, pts),
                               ("lattice", lattice, lat_pts)):
            for two_tier in (False, True):
                print(json.dumps({"kernel": "W0", "mesh": label,
                                  "two_tier": two_tier,
                                  **w0_score_times(mesh, p, two_tier)}))
    return 0


def main_w3_g1_times() -> int:
    from pumiumtally_tpu_torch.experiments import pallas_gather as pg

    phase_device()
    phase_build()
    sms, hz = sm_clock()
    print(f"# {sms} SMs at up to {hz / 1e9:.3f} GHz; package "
          f"{sys.modules['pumiumtally_tpu_torch'].__file__}")
    for name in ("resident_walk", "row_gather"):
        print(f"# {name} SASS: {sass_counts(name) or 'cuobjdump not found'}")
    for dims in W3_CELLS:
        print(json.dumps({"kernel": "W3", "cells": dims,
                          **w3_times(w3_setup(dims), passes=4)}))
    for rows in G1_ROWS:
        tab, idx = g1_inputs(rows)
        for variant, (_, fill) in pg.VARIANTS.items():
            print(json.dumps({"kernel": "G1", "entry": variant,
                              **g1_times(tab, idx, fill, passes=4)}))
    return 0


def staging_arms(fields) -> list:
    """(protocol, knobs) of ``--staging-times``: bench.py's three
    protocols (``two_phase_forced`` where the checkout's TallyConfig has
    ``auto_continue``), each with the defaults and, where the fields
    exist, unvalidated and unfenced."""
    protocols = [("two_phase", {}), ("continue", {})]
    if "auto_continue" in fields:
        protocols.insert(1, ("two_phase_forced", {"auto_continue": False}))
    lean = {"validate_inputs": False, "fenced_timing": False}
    knobs = [{}] + ([lean] if set(lean) <= fields else [])
    return [(p, {**kw, **k}) for p, kw in protocols for k in knobs]


def main_staging_times() -> int:
    """``PumiTally``'s staging at N particles on the box, per protocol
    and knobs: STAGING_PASSES passes of STAGING_MOVES timed moves (host
    clock from the first call to a synchronize after the last: moves/s;
    the calls' own host time: host ms a move), then one profiled move
    (device-busy ms). It calls only ``PumiTally``, ``TallyConfig`` and
    ``build_box``, so a copy times another checkout."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pumiumtally_tpu_torch import PumiTally, TallyConfig, build_box
    from pumiumtally_tpu_torch.experiments.block_rounds import (
        make_trajectory,
    )

    phase_device()
    phase_build()
    print(f"# package {sys.modules['pumiumtally_tpu_torch'].__file__}")
    mesh = build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                     dtype=torch.float32)
    moves = 1 + STAGING_PASSES * (STAGING_MOVES + 1)
    pts = make_trajectory(np.random.default_rng(0), N, moves)
    fields = {f.name for f in dataclasses.fields(TallyConfig)}
    for protocol, knobs in staging_arms(fields):
        t = PumiTally(mesh, N, TallyConfig(check_found_all=False, **knobs))
        t.CopyInitialPosition(flat(pts[0]))

        def move(m):
            if protocol == "continue":
                t.MoveToNextLocation(None, flat(pts[m]))
            else:
                t.MoveToNextLocation(flat(pts[m - 1]), flat(pts[m]),
                                     np.ones(N, np.int8), np.ones(N))

        move(1)  # warm-up
        sync()
        m, rates, host_ms, busy_ms = 2, [], [], []
        for _ in range(STAGING_PASSES):
            calls = 0.0
            t0 = time.perf_counter()
            for _ in range(STAGING_MOVES):
                t1 = time.perf_counter()
                move(m)
                calls += time.perf_counter() - t1
                m += 1
            sync()
            rates.append(N * STAGING_MOVES / (time.perf_counter() - t0))
            host_ms.append(calls / STAGING_MOVES * 1e3)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                move(m)
                sync()
            m += 1
            busy_ms.append(span_us(union(device_spans(prof))) / 1e3)
        print(json.dumps({"protocol": protocol, "knobs": knobs, "n": N,
                          "moves_per_s": rates, "host_ms": host_ms,
                          "device_busy_ms": busy_ms}))
    return 0


def main_unpacked_sentinel() -> int:
    """Phases 1-2 and the unpacked layout's and the sentinel's phases
    alone, with their checks: W0's unpacked entries on the box in float32
    and float64, at both strides, the scoring instantiations' registers,
    the unpacked main
    path, the straggler ladder, intersection_points and the large-mesh
    cell."""
    import torch

    from pumiumtally_tpu_torch import build_box
    from pumiumtally_tpu_torch.experiments.block_rounds import (
        make_trajectory,
    )

    _, smi = phase_device()
    phase_build()
    phase_plane_loads()
    phase_scoring_registers()
    mesh = build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                     dtype=torch.float32)
    pts = make_trajectory(np.random.default_rng(0), N, CONTINUE_MOVES + 2)
    phase_w0_unpacked(mesh, pts)
    box64 = build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                      dtype=torch.float64)
    phase_w0_unpacked(box64, pts, " (float64)", n=W0_F64_N)
    phase_w0_unpacked(mesh, pts, " (plane views)", views=True)
    phase_w0_unpacked(box64, pts, " (plane views, float64)", n=W0_F64_N,
                      views=True)
    del box64
    phase_unpacked_main_path(mesh, pts, smi)
    phase_large_mesh(smi)
    phase_sentinel(mesh, pts, smi)
    phase_xpoints(mesh, pts, smi)
    print(smi)
    return 0


if __name__ == "__main__":
    modes = {"--w0-times": main_w0_times, "--w3-g1-times": main_w3_g1_times,
             "--w4-times": main_w4_times,
             "--staging-times": main_staging_times,
             "--scoring-times": main_scoring_times,
             "--unpacked-sentinel": main_unpacked_sentinel,
             "--resilience": main_resilience,
             "--det-times": main_det_times,
             "--service": main_service,
             "--native": main_native,
             "--multi-device": main_multi_device,
             "--multi-device-rank": main_multi_device_rank,
             "--python-two-phase": main_python_two_phase,
             "--resilience-campaign": main_resilience_campaign,
             "--edges": main_edges}
    import torch

    if not torch.cuda.is_available():  # before the lock: no card, no window
        raise SystemExit("chip_smoke: no CUDA device is available")
    with device_window():
        sys.exit(next((fn for flag, fn in modes.items()
                       if flag in sys.argv[1:]), main)())
