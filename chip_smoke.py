#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--gib 1.0] [--reps 5]
                          [--text-mib 8] [--td-chunks 2048]
                          [--td-plain-rows 256] [--ent-chunks 1024]
                          [--lz-plain-rows 64] [--q-layers 4]
                          [--scalar-plain-elems 2048] [--scalar-reps 5]
                          [--ckpt-layers 4] [--corpus-tokens 16777216]
    python3 chip_smoke.py --stage-only [--src DIR]   # phase 4's build and
                                                     # stage by part, alone
    python3 chip_smoke.py --families-only            # phases 1, 2 and 12
    python3 chip_smoke.py --collectives-only         # phases 1, 2 and 13
    python3 chip_smoke.py --sharded-only             # phases 1, 2 and 14
    python3 chip_smoke.py --mesh-only                # phases 1, 2 and 15
    python3 chip_smoke.py --roofline-only            # phases 1, 2 and 16
    python3 chip_smoke.py --spmd-only                # phases 1, 2 and 17
    python3 chip_smoke.py --spmd-decode-only         # phases 1, 2 and 18
    python3 chip_smoke.py --examples-only            # phases 1, 2 and 19
    python3 chip_smoke.py --ops-only                 # phases 1, 2 and 20

Phases, each of which must pass (any failure exits non-zero, with no result
line); each phase's wall seconds are printed on a line of their own, and
before the result lines all of them and the whole script's:

  1. environment: torch / CUDA versions, the card's name and power limit;
     ``gloo`` must take every collective kind as CUDA tensors, float32 and
     bf16, and the decode path's all-gathers of uint8, int8, int32, int64
     and float16 (``distributed.spmd.probe_backend``: a world of this one
     process);
  2. kernel build: one nvcc (sm_90a) per ``csrc`` source (the single-thread
     ``scalar_decode.cu`` too), all started together, with ptxas registers,
     spills and shared memory, into a fresh compile cache
     (``tuning.enable_compile_cache`` on a new directory under ``build/``);
     then a second interpreter enables the same directory and binds every
     library: its wall time and its nvcc count, which must be 0;
  3. each kernel vs its plain PyTorch version on the card, bit-exact, and
     every row against its input:
       - ``two_phase_rle`` for rle_v1, rle_v2 and dbp at widths 1/2/4, on a
         64-chunk table of 128 KiB chunks plus edge rows (empty chunk,
         one-element tail, 16386-long run, delta wraparound, literals at odd
         offsets, 50 runs of 3 elements) and hand-built rows for its 32-group
         batches and shared-memory ring: a header, a run value or a literal
         group across the 512-, 1,024- and 4,096-byte offsets; for dbp also
         256-element groups of 32-bit fields and malformed groups (fields of
         40 and 255 bits, a payload past the row's end); rows where the
         ``max_groups`` cap lands at groups 32 and 33 (rle_v1, rle_v2);
       - ``bitpack_unpack`` at bits 1/4/7/8/9/17/32 and widths 1/2/4, with
         tail rows, and the weight layout (4-bit fields into u8, 65,536
         elements a chunk);
       - ``tdeflate_decode`` on an empty chunk, a one-byte tail, literals
         only, long overlapping matches, a match reaching before the row's
         start, a stream cut by an invalid code, and hand-built rows for
         its 32-token batches: chained short-distance matches in one batch,
         a match whose source straddles the batch's start, and more than
         32 literals before a 258-long match of distance 1;
       - ``huffman_decode`` on a one-symbol alphabet, 12-bit codes forced by
         the Kraft fix-up, lengths 31/32/33/1023/1024, an empty chunk and a
         full chunk of log text, and rows whose segments leave the kernel's
         staged tile (random bytes, 12-bit codes, shuffled gap entries,
         offsets negative or past the row);
       - every table of every decode kernel again through each fused
         epilogue (u8 -> int8 with a zero, float32 (x - z) * s, bf16 out),
         against the plain version followed by ``Epilogue.apply``, bit for
         bit, each one launch counted as fused;
       - ``lzss_decode`` at widths 1/2/4 on dist-1 and period-3 overlaps,
         128-element literal runs, 129-element matches, a match at the
         65,535 distance limit, and hand-built rows: a match reaching before
         the row's start, a match as the row's first token, a zero
         distance, a stream cut short, and rows for its 32-token batches:
         chained short-distance matches across the batch boundary, a match
         whose source straddles a batch's start, a match whose chain runs
         back through three tokens of its batch, zero-distance matches at
         tokens 31 and 32, 128-element literal runs across the shared ring,
         and rows cut inside a literal run and inside a match's distance;
       - ``dequant_matmul`` within the stated tolerances: on the tensor
         cores (``wgmma``) at bf16 qwen3-1.7B shapes, split-K at a decode
         batch, M = 1 and M = 64; on the SIMT path at the reference test's
         f32 shapes and a bf16 shape TMA cannot describe; each case logs
         the path it took;
  4. the decode path at scale: ``api.compress_many`` ->
     ``api.decompress_many(device_out=True)`` decoding >= ``--gib`` GiB of a
     table scan through all seven codecs in one call (a tdeflate group of
     >= ``--td-chunks`` chunks of log text, a huffman group of the same text
     and an lzss group of its u32 token ids, each >= ``--ent-chunks``
     chunks), checked against the inputs, with every kernel's launch count,
     the decode time, output GB/s, and each plan group's kernel time, bound
     and plain-version time (tokens or groups a chunk for tdeflate, lzss
     and the RLE family); before it, ``DecodePlan.build`` and ``stage`` of
     the same blobs by part, cold and warm, with the upload's GB/s;
  5. epilogues in the kernels' stores against their plain torch versions:
     an rle_v2 column, a bitpack column, the log text through huffman and
     tdeflate, the lzss token shard; then the fused decode timed against
     the kernel followed by ``Epilogue.apply`` (rle_v2, tdeflate, lzss),
     and tdeflate's on phase 4's staged 2,048-chunk group by device time
     (the three interleaved, median of ``--reps``), equal bit for bit;
  6. the quantized-weight path: ``decompress_dequant_matmul`` over the seven
     projections of ``--q-layers`` layers of qwen3-1.7B (W4A16: 4-bit
     bitpacked int8 weights, bf16 activations) at M = 128 and M = 2048,
     checked against the plain version (every call on the ``wgmma``
     path, every weight decode one ``bitpack_unpack`` launch with the
     zero-point epilogue fused), then timed in its steady state (cached
     plan, no host transfers): decode, kernel, plain version and
     ``torch.matmul`` on the dequantized weights, apart, per projection,
     and one sweep over all projections a rep, whose weights exceed the L2
     cache; the weight decode split into the host clock of the call and
     the device time of its launch;
  7. the serving layer: phase 4's arrays through one
     ``DecompressionService`` (256 MiB decoded-blob cache, pow2 buckets)
     from 8 producer threads, one ``submit_array`` a request, every other
     one ``device_out``, twice (the second pass meets the cache), each
     result bit-exact, with windows, blobs and dispatches a window, dispatch
     amplification, hit rate, p50/p99 latency and GB/s, and every decode
     kernel launched; then the same two passes through services with
     and without pow2 buckets in turns (the buckets' padding cost, with
     the bytes each pass stages); ``api.decompress_many(cas)`` through
     ``default_service()`` beside the direct plan path (equal dispatches
     and outputs); then every blob written to a filesystem backend and
     restored through a ``TieredBlobStore`` under a host budget well below
     the data, ``stream_windows(window=8)`` + ``submit_key``: each key
     fetched once, evictions, bit-exact;
  8. the §V-E ablation: phase 4's staged plan through
     ``CodagEngine(EngineConfig(all_thread=False))`` with
     ``execute_device``, one single-thread launch (``scalar_decode.cu``,
     one thread a chunk) a group, counted, every blob bit for bit against
     the inputs and the all-thread output; per group and in total the
     single-thread kernel's device time beside the all-thread kernel's and
     their ratio; each entry against its plain scalar body on phase 4's
     plain-version rows, each row's first ``--scalar-plain-elems``
     elements (the plain bodies take one step of torch ops an element);
  9. tuning: ``tuning.autotune(smoke=True)`` on the card into an in-memory
     table (never saved), tuned and default MB/s and the knob point of
     each codec; then ``api.compress(arr, codec)`` with
     ``chunk_bytes=None`` for every codec: the card's kind has no row, so
     128 KiB chunks;
 10. the decode path's consumers (``repro_torch.checkpoint``,
     ``repro_torch.data``, ``repro_torch.distributed.fault``):
       - the AdamW int8 moments (per-128-block f32 scales) of
         ``--ckpt-layers`` qwen3-1.7B layers at full widths saved with
         bitpack, and one layer's bf16 K and V weights with tdeflate; each
         restored on the host, with ``device_out`` and with ``device_out``
         streamed through a filesystem store under a budget below the
         checkpoint (each key fetched once): timed, bit for bit equal to
         the saved state and to the host restore, launches by kernel;
       - ``synthetic_corpus(--corpus-tokens, vocab=151936)`` spilled as
         rle_v2 shards under a host budget below the compressed corpus,
         one epoch through ``CompressedLoader(batch=8, seq=4096,
         device_out=True)`` in engine mode (``decode_window=4``, prefetch
         thread) and in service mode: tokens/s, every batch equal to the
         corpus, no prefetch thread left after the iterator is dropped;
       - a ``FaultTolerantRunner`` whose step updates a card tensor from
         the loader's batches, rle_v2 checkpoints every 5 steps (async),
         failures injected at 2 steps: 2 restarts, every restore on the
         card through ``two_phase_rle``, equal to the state saved at its
         step;
 11. the model stack (``repro_torch.models``, ``optim``, ``launch``):
       - (a) ``launch.serve.run_serving`` of qwen3-1.7B at full width and
         depth (28 layers, 2.03 B parameters, bf16): 8 prompts of 64
         tokens, 32 greedy tokens; prefill s, decode tok/s and decode-step
         ms beside the step's weight-read bound; every position's
         ``decode_step`` logits against ``forward``'s within a stated bf16
         tolerance, and the greedy tokens against ``forward``'s argmax
         wherever its top-2 margin exceeds twice that tolerance;
       - (b) ``launch.train.run_training`` at full width cut to 4 layers,
         batch 8 x seq 512, ``--grad-int8 --compress-moments``, 12 steps,
         checkpoints every 5, a failure at step 7: the loss falls, one
         restart restored on the card, one fused ``bitpack_unpack`` launch
         a gradient leaf a step (the wire's per-row scale in its stores;
         the first step's each equal to the plain body + ``Epilogue.apply``
         bit for bit), rle_v2 launches from the loader, each equal to
         the plain rle_v2 body on its inputs bit for bit, and every batch
         the driver drew equal to the corpus it built; step ms beside
         ``train_step_bound`` (the matmuls at 6 FLOP a parameter a token,
         the embedding table gathered, plus causal attention, at the bf16
         peak), and one step's wire decode, device time, beside its bytes
         bound;
       - (c) 2 layers at full width in float32, TF32 off: ``forward`` and
         ``loss_fn`` on the card equal the same on the CPU on the same
         weights (rtol = atol = 1e-3);
 12. the other families (``models/moe.py``, ``models/ssm.py``), each
     part's seconds and peak memory printed:
       - (a)-(c) ``run_serving`` as in 11 (a), at full width: qwen3-moe-
         235B-A22B cut to 4 layers (``--n-layers``), its check at capacity
         factor n_experts / top_k (nothing dropped); rwkv6-1.6B (24
         layers) and zamba2-2.7B (54 Mamba2 layers, the shared block 9
         times) whole; each step beside ``decode_step_bytes`` (every
         expert read; the shared block once an application; recurrent
         states read and written), the MoE's also beside the experts its
         routes reach; decode against ``forward`` in bf16 within fixed
         limits (the MoE on ``forward``'s routes, each route its own
         top-k would change a near tie by the rounding on those routes),
         and the recurrent families' decode, in float32 on the served
         weights at full depth, within ``SERVE_F32_TOL`` of ``forward``;
       - (d), (e) ``run_training`` as in 11 (b) without the failure: the
         MoE at 1 layer (3.73 B parameters, 805 M-element expert leaves on
         the wire) and zamba2 at 6 layers, 8 x 512, 6 steps at lr 1e-5:
         the loss falls, every loader decode and batch and the first
         step's wire decodes (in row slices) held bit for bit, step ms
         beside ``train_step_bound`` (an MoE token through its top-k
         experts, the capacity padding's share printed beside it);
       - (f) float32 on the card against the CPU: rwkv6 (2 layers), zamba2
         (6 layers, one shared application), qwen3-moe (2 layers, 16
         experts);
 13. the collective plane (``distributed/collectives.py``,
     ``distributed/diloco.py``, ``launch/mesh.py``), its members sharing the
     card:
       - (a) ``compressed_psum``'s receive path, bitpack's second entry
         ``codag_bitpack_reduce`` (the dequant and the member mean in its
         stores), on qwen3-1.7B's embedding leaf (151,936 x 2,048 float32
         a member, 2.43 M wire rows of 128) at 2 and 4 members: one launch,
         equal to the plain version (bitpack body, ``Epilogue.apply``, the
         ``MemberReduce``) bit for bit, ms and device ms beside its bytes
         bound; then the edge cases (a leaf not a multiple of 128 over 1,
         2, 3 and 8 members, sum and mean; a ragged gather);
       - (b) ``compressed_psum``, ``topk_psum`` and ``make_tree_reduce``
         (int8, top-k, none) on 2- and 4-member meshes on the card against
         the same on the CPU: within one int8 grid step, the share of
         elements that differ printed;
       - (c) ``launch.train.run_training`` with ``--diloco 2``: qwen3-1.7B
         at full width and 4 layers, 8 x 512 a pod, the rle_v2 loader,
         ``--grad-int8 --compress-moments``, lr 1e-5, ``--outer-every
         4``: 12 steps with the int8 outer wire, then 8 with top-k 1%; the
         loss falls, the pods equal each other after every sync, each int8
         sync's anchor within the int8 grid bound of a float32 Nesterov
         step on the plain member mean of the same deltas, one
         ``codag_bitpack_reduce`` launch a leaf a sync and no unfused
         epilogue; the overlap stats, ``wire_report``, and one sync's
         device ms beside its bytes bound;
 14. mesh placement (``DecodePlan.execute_sharded``, ``restore(
     shardings=)``, ``CompressedLoader(mesh=)``, ``distributed/
     sharding.py``), on ``make_test_mesh`` meshes whose members share the
     card:
       - (a) phase 4's table scan through ``decompress_many(mesh=,
         out_shardings=decode_out_sharding(mesh))`` on 4 ``data``
         members, then on the least count (at least 3) that pads every
         group with zero-length rows: one launch a group, every member's
         shard equal to phase 4's ``execute_device`` output bit for bit;
         build, staging, decode and placement apart, the staged plan
         beside ``execute_device`` with no host transfer; the padded plan
         through ``all_thread=False`` (``scalar_decode.cu``);
       - (b) phase 10's checkpoints restored with ``shardings=``
         (``opt_shardings`` for the moments, ``param_shardings`` for the
         K/V weights) onto (data=2, model=2), then elastically onto
         (data=4, model=1) and (data=1, model=4), through the engine and
         through a store, ``device_out``: every shard equal to the
         unsharded restore's block, no device->host transfer;
       - (c) phase 10's corpus through ``CompressedLoader(mesh=)`` on 2
         members: every batch's ``full()`` equal to engine mode's;
         tokens/s;
       - (d) ``optim/adamw.py``'s int8 quantizer on the card against the
         CPU on the moments of phase 11 (b)'s blocks: 0 elements differ;
 15. the model's steps under a mesh of the card (``sharding.use_mesh``,
     ``launch.steps.sharded_step``, the drivers' ``--mesh``, the runner's
     ``reshard_fn``), every number beside the card's name and power limit:
       - (a) phase 11 (b)'s training run (4 full-width qwen3-1.7B layers,
         8 x 512, ``--grad-int8 --compress-moments``, lr 1e-5) for 6 steps
         on a (pod 2, data 2, model 2) mesh under both policies and without
         a mesh: every loss, parameter and moment equal bit for bit, the
         loader and wire held as in 11 (b); step ms beside
         ``train_step_bound``, wire launches a step, peak memory;
       - (b) phase 11 (a)'s serve on the same mesh (``serve_shardings``)
         and without one: every token and every cache leaf (assembled)
         equal; tok/s, and the device ms of a step's parameter gather;
       - (c) qwen3-moe-235B-A22B at full width and 1 layer, a prefill of 8
         x 128 on the mesh (``dp_groups`` 4): the logits against each DP
         block run alone through the unsharded prefill step within
         ``SERVE_TOL``;
       - (d) phase 11 (b)'s run (12 steps, checkpoints every 5, a failure
         at step 7) on a 4x2 (data, model) mesh, restarted onto a 2x2 mesh
         (``--restart-mesh``): its losses and final state equal an
         uninterrupted unsharded run over the batches its steps drew;
 16. the roofline on the card (``roofline/count.py``,
     ``roofline/analysis.py``, ``launch/dryrun.py``), every number beside
     the card's name and power limit:
       - (a) phase 11 (a)'s decode step (28 layers, batch 8, a 104-position
         cache) and phase 11 (b)'s train step without the wire (4 layers,
         8 x 512, int8 moments), each counted under ``count_costs`` on the
         card and on ``meta``: FLOPs, bytes, collective bytes and ops
         equal, temp peaks within ``COUNT_PEAK_TOL``;
       - (b) each step's measured ms (median of ``ROOFLINE_REPS``) beside
         its counted roofline (``t_compute``, ``t_memory``, ``dominant``,
         ``t_bound``) and the ratio, and its analytic bound;
       - (c) the train step's arguments plus the counted temp bytes
         against ``torch.cuda.max_memory_allocated`` over one step, within
         ``MEMORY_TOL``;
       - (d) ``python -m repro_torch.launch.dryrun --arch qwen3-1.7b
         --shape decode_32k`` in a subprocess: its record, ``ok``;
 17. the member program split over ``model`` (``launch.steps.member_step``,
     ``distributed.spmd``, ``launch.mesh.spawn``), 4 ``gloo`` processes on
     the card, each holding only its blocks, every number beside the
     card's name and power limit; the unsharded runs on the card first,
     written for the members to read:
       - (a) phase 11 (b)'s 4 full-width qwen3-1.7B layers, 8 x 512, one
         step with the int8 wire and int8 moments at lr 1e-5 on (data 2,
         model 2): the loss within ``SPMD_LOSS_TOL``, every parameter
         element within AdamW's two-step bound, the moments within
         ``SPMD_MOMENT_TOL`` (relative L2), one ``bitpack_unpack`` launch
         a wire leaf a member, each of the first step's wire decodes held
         to the plain bitpack body + ``Epilogue.apply`` bit for bit
         (``check_wire``); ms a step against the unsharded step;
       - (b) the same weights decoding on (data 1, model 4): a 16-token
         prompt, then 8 steps fed the unsharded run's tokens, every
         step's logits and each member's cache block within
         ``SERVE_TOL``; ms a step against the unsharded step;
       - (c) qwen3-moe-235B-A22B at 1 layer, a prefill of 8 x 128 on
         (data 2, model 2), 64 experts a member, on the unsharded run's
         routes (``RouteTape``), the logits within ``SERVE_TOL`` of
         each DP block alone, the members' own router logits within
         ``SPMD_ROUTER_TOL`` of the unsharded run's and every route their
         own top-k would change a near tie (``near_tie_flips``);
       - each part's time in collectives by kind (``spmd.Member.
         transfer_s``), no ``nvcc`` in a member (they bind phase 2's
         builds), and ``nccl`` asked to put two ranks on the one card (it
         refuses);
 18. the decode path one process a member (``DecodePlan.execute_sharded``,
     ``gather_member_tables``, the compressed collectives, ``restore(
     shardings=)`` / ``save(shardings=)``, DiLoCo and the runner on meshes
     over a world's ranks), 4 ``gloo`` processes on the card, each
     holding only its blocks, every number beside the card's name and
     power limit; what they are held to computed on the card first and
     written for the members to read:
       - (a) phase 4's scan through ``decompress_many(mesh=world mesh
         (data 4), out_shardings=decode_out_sharding)``: one launch a
         group a member, every member's block equal to phase 4's
         ``execute_device`` output's (checksums), staging, decode, the
         exchange (the decoded group tables all-gathered: ms and bytes)
         and the rest apart;
       - (b) phase 10's int8 moments and K/V weights restored with
         ``shardings=`` onto (data 2, model 2): every block equal to the
         unsharded restore's, launches by kernel;
       - (c) ``compressed_psum`` of phase 13 (a)'s embedding-sized leaf a
         pod at 2 pods (each held by 2 data members) and 4: one
         ``codag_bitpack_reduce`` launch a member, equal to the
         one-process reduce of the same leaves; the reduce's device ms,
         the gathers' ms and bytes;
       - (d) ``train --diloco 2 --spmd`` (phase 13 (c)'s run, one process
         a pod, cut to ``SPMD_DILOCO_STEPS`` steps): the loss falls, the
         pods' anchors equal after every sync, one reduce launch a leaf a
         sync and no unfused epilogue, the overlap stats;
       - (e) ``train --spmd`` at (data 2, model 2) (phase 17 (a)'s run,
         ``SPMD_FAIL_FLAGS``): one restart, every member's final blocks
         and the losses equal to the member program run without the
         failure over the batches its steps drew;
 19. the examples (``examples/torch_*.py``) and the registry gate
     (``scripts/torch_check_registry.py``) on the card: the serve and train
     veneers (zamba2-2.7B tiny; olmo-1B small, ``--steps 8``) as
     subprocesses on phase 2's compile cache, started first, each exiting
     0 after its driver's "OK"; then, in this process with its standard
     output captured, the quickstart, the compressed checkpoint, the
     streaming restore and ``torch_check_registry.main(["--device",
     "cuda"])``, each ending "OK" (or "registry complete") after its
     reference's check lines, with every launch count set to 0 before each
     and read after: the quickstart must launch rle_v1, rle_v2, tdeflate
     and the single-thread kernel, the checkpoint examples rle_v2, the gate
     all seven decode kernels; each run's seconds and launches;
 20. the per-blob decode entry points (``kernels/ops.py``
     ``decode_blob``, ``decode_table``, ``decode_table_device``;
     ``format.reassemble_device``), every number beside the card's name
     and power limit:
       - (a) every golden vector of every codec (``tests/vectors/*.json``)
         through ``ops.decode_blob`` on the ``cuda``, ``torch``, ``oracle``
         and ``scalar`` backends on the card, each equal to its input in
         dtype, shape and bits: the reference's conformance suite;
       - (b) one blob of each of phase 4's groups through
         ``decode_table_device(blob, "cuda")``, equal to its rows of phase
         4's ``execute_device`` table bit for bit, and
         ``reassemble_device`` of it equal to ``decode_blob``'s host
         array; each group's ``concat_blobs`` table through
         ``decode_table_device`` as one launch, equal to phase 4's table;
       - (c) each of those blobs' host ms of ``decode_blob`` and device ms
         of ``decode_table_device``, beside phase 4's ``decompress_many``
         parts (build, staging, decode); the launches of (a) and (b) by
         kernel;
 21. a JSON line of the kernels (``consumer_launches``: phase 10's,
     ``model_launches``: phase 11's, ``family_launches``: phase 12's,
     ``diloco_launches``: phase 13's, ``sharded_launches``: phase 14's,
     ``mesh_launches``: phase 15's, ``spmd_launches``: phase 17's,
     ``spmd_decode_launches``: phase 18's, each over its members, and
     ``examples_launches``: phase 19's in-process runs, summed;
     ``ops_launches``: phase 20's, on every decode kernel, each at least 1;
     ``bitpack_reduce``, bitpack's second entry, with phase 13's numbers),
     then ``{"ok": true, "device": {...}}`` last.

It imports nothing of JAX and nothing of the JAX package ``repro``.  It
exits non-zero without a card, or without the port's sources beside it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import runpy
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

T_START = time.perf_counter()      # the script's wall clock starts here

# the allocator ``python -m repro_torch.launch.train`` runs with (its
# ``ALLOC_CONF``: phase 12's MoE training fragments fixed-size segments),
# set before torch first uses the card, so every phase runs under it
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CHUNK_BYTES = 128 * 1024           # the paper's chunk size
TD_EDGE_CHUNK = 32 * 1024          # tdeflate edge rows (plain body: a step
                                   # per token, so keep the rows short)
STORE_BUDGET = 128 << 20           # the restore's host budget (phase 7):
                                   # well under phase 4's 463.5 MiB of blobs
STORE_WINDOW = 8                   # blobs a window of the restore


def log(msg: str) -> None:
    print(msg, flush=True)


def ms_of(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps: int, sleep_cycles: int = 2_000_000) -> float:
    """Median milliseconds of the work ``fn()`` queues on the card, over
    ``reps`` runs: CUDA events with the stream held busy (a device sleep of
    ``sleep_cycles``, about a millisecond by default) until ``fn`` has
    queued its launches, so the wrapper's host time does not fall between
    the events, as it does in :func:`ms_of` when the card is idle."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


# --------------------------------------------------------------------------
# data, made from the seed
# --------------------------------------------------------------------------

DT = {1: np.uint8, 2: np.uint16, 4: np.uint32}
KERNELS = ("two_phase_rle<rle_v1>", "two_phase_rle<rle_v2>",
           "two_phase_rle<dbp>", "bitpack_unpack", "tdeflate_decode",
           "huffman_decode", "lzss_decode", "dequant_matmul",
           "scalar_decode")
# kernel -> (source under src/repro_torch/csrc, the TPU kernel it replaces)
SOURCES = {
    "bitpack_unpack": ("bitpack_unpack.cu", "src/repro/kernels/bitpack.py:55"),
    "tdeflate_decode": ("tdeflate_decode.cu",
                        "src/repro/kernels/tdeflate.py:50"),
    "huffman_decode": ("huffman_decode.cu",
                       "src/repro/kernels/huffman.py:237"),
    "lzss_decode": ("lzss_decode.cu", "src/repro/kernels/lzss.py:245"),
    "dequant_matmul": ("dequant_matmul.cu",
                       "src/repro/kernels/dequant_matmul.py:53"),
    # not a Pallas kernel: the reference's single-thread backend is jax.vmap
    # of each codec's body_scalar
    "scalar_decode": ("scalar_decode.cu", "src/repro/kernels/harness.py:345"),
}
# qwen3-1.7B (src/repro/configs/qwen3_1b7.py, hf:Qwen/Qwen3-1.7B): one
# layer's projections as (name, K, N) of y = x @ W
D_MODEL, N_HEADS, N_KV_HEADS, HEAD_DIM, D_FF = 2048, 16, 8, 128, 6144
QWEN3_PROJECTIONS = (
    ("q", D_MODEL, N_HEADS * HEAD_DIM), ("k", D_MODEL, N_KV_HEADS * HEAD_DIM),
    ("v", D_MODEL, N_KV_HEADS * HEAD_DIM), ("o", N_HEADS * HEAD_DIM, D_MODEL),
    ("gate", D_MODEL, D_FF), ("up", D_MODEL, D_FF), ("down", D_FF, D_MODEL))
Q_BATCHES = (128, 2048)            # a decode batch and a prefill chunk
TOL = {torch.float32: (5e-3, 1e-4),     # the reference test's own
       torch.bfloat16: (1.6e-2, 1e-2)}  # two bf16 ulps


def kernel_of(codec: str) -> str:
    named = {"bitpack": "bitpack_unpack", "tdeflate": "tdeflate_decode",
             "huffman": "huffman_decode", "lzss": "lzss_decode"}
    return named.get(codec, f"two_phase_rle<{codec}>")


def runs(rng, values: np.ndarray, max_run: int, n: int) -> np.ndarray:
    out = np.repeat(values, rng.integers(1, max_run, len(values)))
    if len(out) < n:
        out = np.resize(out, n)
    return out[:n]


LEVELS = ("INFO", "DEBUG", "WARN", "ERROR")


def log_corpus(rng, n_bytes: int, n_tokens: int = 0):
    """Synthetic log lines: an ISO timestamp, a level, and 5-15 words drawn
    by Zipf(1.1) from a 5,000-word vocabulary of random letters.  Returns
    the first ``n_bytes`` of the text, and the first ``n_tokens`` of the
    lines' token ids as u32, as a tokenized corpus stores them (lines are
    drawn until both are long enough): a word's id is its vocabulary index,
    a level is 5000 + its index in LEVELS, an end of line 5004."""
    vocab = ["".join(chr(97 + c) for c in rng.integers(0, 26,
                                                      rng.integers(3, 11)))
             for _ in range(5000)]
    p = np.arange(1, 5001, dtype=np.float64) ** -1.1
    p /= p.sum()
    levels = ("INFO", "INFO", "INFO", "DEBUG", "WARN", "ERROR")
    lines, ids, size, ms = [], [], 0, 0
    while size < n_bytes or len(ids) < n_tokens:
        ms += int(rng.integers(0, 2000))
        sec = ms // 1000
        drawn = rng.choice(5000, int(rng.integers(5, 16)), p=p)
        words = " ".join(vocab[i] for i in drawn)
        level = levels[int(rng.integers(0, len(levels)))]
        line = (f"2026-03-{1 + sec // 86400 % 28:02d}T{sec // 3600 % 24:02d}:"
                f"{sec // 60 % 60:02d}:{sec % 60:02d}.{ms % 1000:03d}Z "
                f"{level} {words}\n")
        if size < n_bytes:
            lines.append(line)
            size += len(line)
        if len(ids) < n_tokens:
            ids.append(5000 + LEVELS.index(level))
            ids.extend(drawn.tolist())
            ids.append(5004)
    text = np.frombuffer("".join(lines).encode()[:n_bytes], np.uint8).copy()
    return text, np.array(ids[:n_tokens], np.uint32)


def log_text(rng, n_bytes: int) -> np.ndarray:
    return log_corpus(rng, n_bytes)[0]


def scan_columns(rng, col_bytes: int):
    """A table scan's columns: (name, array, codec)."""
    n4 = col_bytes // 4
    m = n4 // 30 + 1
    ids = runs(rng, np.cumsum(rng.integers(1, 1000, m)).astype(np.uint32),
               120, n4)
    seg = rng.integers(100, 5000, n4 // 100 + 1)
    steps = np.repeat(rng.integers(-5, 6, len(seg)), seg)[:n4]
    ramp = (np.int64(1 << 20) + np.cumsum(steps)).astype(np.int32)
    vals = runs(rng, rng.normal(size=m).astype(np.float32), 80, n4)
    flags = runs(rng, rng.integers(0, 4, col_bytes // 60 + 1).astype(np.uint8),
                 200, col_bytes)
    codes = runs(rng, rng.integers(0, 1000, col_bytes // 100 + 1)
                 .astype(np.uint16), 100, col_bytes // 2)
    n8 = col_bytes // 8
    ts_steps = np.repeat(rng.choice(np.array([0, 1000, 5000]), n8 // 200 + 1),
                         200)[:n8]
    ts = np.int64(1_700_000_000_000_000_000) + np.cumsum(ts_steps)
    order_ids = np.cumsum(rng.integers(0, 16, n4)).astype(np.uint32)
    event_ts = np.int64(1_773_000_000_000_000_000) + np.cumsum(
        1_000_000 + rng.integers(-200_000, 200_000, n8))
    dict_u32 = rng.integers(0, 1 << 9, n4).astype(np.uint32)
    dict_u16 = rng.integers(0, 1 << 11, col_bytes // 2).astype(np.uint16)
    return [("ids_u32", ids, "rle_v1"), ("ramp_i32", ramp, "rle_v2"),
            ("vals_f32", vals, "rle_v1"), ("flags_u8", flags, "rle_v2"),
            ("codes_u16", codes, "rle_v1"), ("ts_i64", ts, "rle_v2"),
            ("order_ids_u32", order_ids, "dbp"),
            ("event_ts_i64", event_ts, "dbp"),
            ("dict_codes_u32", dict_u32, "bitpack"),
            ("dict_codes_u16", dict_u16, "bitpack")]


def edge_arrays(rng, width: int, chunk_elems: int):
    """Edge rows for one width, each its own blob."""
    dt = DT[width]
    top = 1 << (8 * width)
    base = runs(rng, rng.integers(0, 50, 64).astype(dt), 40, chunk_elems)
    odd = np.concatenate([  # literal runs at odd byte offsets
        np.concatenate([rng.integers(0, top, 5, dtype=np.uint64).astype(dt),
                        np.full(3, 7, dt)]) for _ in range(200)])
    wrap = ((top - 50 + 7 * np.arange(3000, dtype=np.int64)) % top).astype(dt)
    threes = np.repeat(np.arange(50) % 2 + 2 * rng.integers(0, 100, 50), 3)
    return {
        "empty": np.zeros(0, dt),
        "one_elem_tail": np.resize(base, chunk_elems + 1),
        "run_16386": np.full(16386 + 5, 9, dt),
        "delta_wrap": wrap,
        "odd_literals": odd,
        "runs_of_3": threes.astype(dt),
    }


# where the RLE kernel's 1 KiB ring blocks and 4 KiB ring meet, and a
# 512-byte mark
RING_OFFSETS = (512, 1024, 4096)


def rle_ring_rows(rng, codec: str, width: int):
    """Hand-built rows for the RLE kernel's ring and 32-group batches: a
    group header, a run value or a literal group across each of
    ``RING_OFFSETS``, then 40 short groups.  (name, group list) each."""
    top = 1 << (8 * width)
    v = lambda n: rng.integers(0, top, n, dtype=np.uint64)  # noqa: E731
    if codec == "rle_v1":
        kinds = {"run_value": (1, [("run", 5, v(1)[0])]),
                 "literal_128": (3, [("lit", v(128))])}
        tail = [("run", 3, x) for x in v(20)] + [("lit", v(1))] * 20
    elif codec == "rle_v2":
        kinds = {"long_header": (1, [("long", 1000, v(1)[0])]),
                 "delta_base": (width, [("delta", 20, v(1)[0], 3)]),
                 "literal_64": (5, [("lit", v(64))])}
        tail = [("run", 3, x) for x in v(20)] + [("lit", v(1))] * 20
    else:
        kinds = {"header": (1, [("dbp", 13, v(1)[0], v(100) % 8192)]),
                 "payload": (3 + width, [("dbp", 32, v(1)[0], v(256))])}
        tail = [("dbp", 2, x, [1, 2, 3]) for x in v(40)]
    return [(f"{k}_at_{o}", [("fill", o - back)] + groups + tail)
            for o in RING_OFFSETS for k, (back, groups) in kinds.items()]


def dbp_model(row: bytes, width: int, n: int) -> np.ndarray:
    """What a dbp row decodes to, as the reference's body reads it, also
    where it is malformed: element k of a group is the 40-bit window at bit
    ``payload * 8 + k * bits``, shifted and masked to ``bits`` (all ones
    from 32 up), plus the reference, mod 2^32.  Reads past the row's bytes
    are zero (its padding)."""
    def byte(p):
        return row[p] if p < len(row) else 0

    def value(p, w):
        return sum(byte(p + b) << (8 * b) for b in range(w))

    out, pos = [], 0
    while len(out) < n:
        bits, count = byte(pos), byte(pos + 1) + 1
        ref, off = value(pos + 2, width), pos + 2 + width
        mask = 0xFFFFFFFF if bits >= 32 else (1 << bits) - 1
        for k in range(count):
            bp = off * 8 + k * bits
            out.append((ref + ((value(bp >> 3, 5) >> (bp & 7)) & mask))
                       & 0xFFFFFFFF)
        pos = off + (count * bits + 7) // 8
    return np.array(out[:n], np.uint64).astype(DT[width])


def row_blob(fmt, codec: str, row: bytes, width: int, n: int):
    """One hand-built chunk row of n elements as a blob."""
    return fmt.CompressedBlob(
        codec=codec, width=width, chunk_elems=CHUNK_BYTES // width,
        total_elems=n, orig_dtype=str(np.dtype(DT[width])), orig_shape=(n,),
        comp=np.frombuffer(row, np.uint8)[None].copy(),
        comp_lens=np.array([len(row)], np.int32),
        out_lens=np.array([n], np.int32))


def dbp_malformed(rng, fmt, width: int):
    """dbp groups no encoder writes: 256 fields of 40 bits, and of 255
    bits with the payload past the row's end.  (name, blob, expected)."""
    out = []
    for name, bits, nbytes in (("bits_40", 40, 1400), ("bits_255", 255, 900)):
        row = bytes([bits, 255]) + bytes(rng.integers(0, 256, width + nbytes,
                                                      dtype=np.uint8))
        out.append((name, row_blob(fmt, "dbp", row, width, 300),
                    dbp_model(row, width, 300)))
    return out


def dbp_wide_groups(rng, fmt, width: int):
    """A chunk of 256-element dbp groups with 32-bit fields (the encoder
    writes 128-element groups, so it is built here) and what it decodes to:
    ref + field mod 2^32, in the width type."""
    ngroups = min(8, CHUNK_BYTES // width // 256)
    refs = rng.integers(0, 1 << (8 * width), ngroups, dtype=np.uint64)
    fields = rng.integers(0, 1 << 32, (ngroups, 256), dtype=np.uint64)
    row = bytearray()
    for r, f in zip(refs, fields):
        row += bytes([32, 255]) + int(r).to_bytes(8, "little")[:width]
        row += f.astype(np.uint32).tobytes()
    want = ((refs[:, None] + fields) % (1 << 32)).astype(np.uint32) \
        .astype(DT[width]).reshape(-1)
    total = want.size
    blob = fmt.CompressedBlob(
        codec="dbp", width=width, chunk_elems=CHUNK_BYTES // width,
        total_elems=total, orig_dtype=str(np.dtype(DT[width])),
        orig_shape=(total,), comp=np.frombuffer(bytes(row), np.uint8)[None],
        comp_lens=np.array([len(row)], np.int32),
        out_lens=np.array([total], np.int32))
    return blob, want


def inflate_tokens(tokens, chunk: int) -> np.ndarray:
    """What a token list decodes to in a ``chunk``-byte row, one byte at a
    time.  A match's window starts at ``cnt - dist``; a negative start is
    placed as ``lax.dynamic_slice`` places it (plus the buffer's length,
    ``chunk + 272``, clamped to ``[0, chunk]``), and byte i reads
    ``out[start + min(i % dist, 271)]``: an earlier byte, or zero at or
    past the current position."""
    out = []
    for t in tokens:
        if t[0] == "l":
            out.append(t[1])
            continue
        _, length, dist = t
        cnt = len(out)
        start = cnt - dist
        if start < 0:
            start = min(max(start + chunk + 272, 0), chunk)
        for i in range(length):
            j = start + min(i % dist, 271)
            out.append(out[j] if j < cnt else 0)
    return np.array(out, np.uint8)


# rows for the tdeflate kernel's 32-token batches (a token list each)
TD_BATCH_ROWS = {
    # short-distance matches in one batch, each reading the one before it
    "chained_matches": [("l", 97), ("l", 98), ("l", 99)]
    + [("m", 4 + i, 3 + i) for i in range(10)] + [("l", 10)],
    # a match of the second batch whose source straddles the batch's start
    "straddles_batch_start": [("l", 65 + i % 26) for i in range(40)]
    + [("m", 10, 12)] + [("l", 48 + i) for i in range(5)],
    # more than 32 literals, then a match of distance 1 and length 258
    "literals_then_run_258": [("l", 97 + i % 26) for i in range(40)]
    + [("m", 258, 1), ("l", 33)],
}


def tdeflate_edge_blobs(rng, enc, fmt, chunk: int):
    """tdeflate edge rows: (name, blob, expected bytes)."""
    text = log_text(rng, chunk + 1)
    arrays = {
        "empty": np.zeros(0, np.uint8),
        "one_byte_tail": text,
        "literals_only": rng.integers(0, 256, chunk).astype(np.uint8),
        "overlap_ab": np.frombuffer(b"ab" * 40000, np.uint8).copy(),
        "overlap_abcd": np.frombuffer(b"abcd" * 9000 + b"a" * 300, np.uint8)
        .copy(),
    }
    out = [(k, enc.compress(a, "tdeflate", chunk), a)
           for k, a in arrays.items()]
    # a first match that reaches 3 bytes before the row's start
    tokens = [("l", 65), ("m", 5, 3), ("l", 66), ("m", 40, 30), ("m", 9, 2)]
    want = inflate_tokens(tokens, chunk)
    blob = enc.tdeflate_blob(want, [enc.encode_tdeflate_tokens(tokens)],
                             chunk, want.size)
    out.append(("before_start", blob, want))
    # a stream cut by an invalid code: '~' occurs once (log text has none),
    # and its LUT entries are cleared, so the parse stops there (nb == 0);
    # the rest of the row is zero
    cut = np.concatenate([text[:chunk // 2], np.frombuffer(b"~", np.uint8),
                          text[chunk // 2:chunk - 1]])
    blob = enc.compress(cut, "tdeflate", chunk)
    hit = blob.extras["lut_lsym"] == ord("~")
    blob.extras["lut_lbits"][hit] = 0
    blob.extras["lut_lsym"][hit] = 0
    want = cut.copy()
    want[chunk // 2:] = 0
    out.append(("cut_invalid_code", blob, want))
    for name, tokens in TD_BATCH_ROWS.items():
        want = inflate_tokens(tokens, chunk)
        out.append((name, enc.tdeflate_blob(
            want, [enc.encode_tdeflate_tokens(tokens)], chunk, want.size),
            want))
    return out


def huffman_edge_arrays(rng, chunk: int):
    """huffman edge rows: name -> bytes, each its own blob."""
    fib = [1, 1]
    while len(fib) < 24:            # Fibonacci counts want > 12-bit codes
        fib.append(fib[-1] + fib[-2])
    kraft = np.repeat(np.arange(24, dtype=np.uint8), fib)
    rng.shuffle(kraft)
    geo = lambda n: np.minimum(rng.geometric(0.25, n) - 1,  # noqa: E731
                               255).astype(np.uint8)
    return {"one_symbol": np.full(5000, 9, np.uint8),
            "kraft_12bit": kraft,
            **{f"len_{n}": geo(n) for n in (31, 32, 33, 1023, 1024)},
            "empty": np.zeros(0, np.uint8),
            "log_text_tail": log_text(rng, chunk + 1)}


def huffman_tile_rows(rng, enc, chunk: int):
    """huffman rows whose segments leave the kernel's staged tile: random
    bytes (8-bit codes fill a batch's 2,048-word tile, so its last
    segments overflow it), 12-bit codes, shuffled gap entries (offsets out
    of order), offsets negative or past the row.  (name, blob) each."""
    fib = [1, 1]
    while len(fib) < 24:
        fib.append(fib[-1] + fib[-2])
    kraft = np.repeat(np.arange(24, dtype=np.uint8), fib)
    rng.shuffle(kraft)
    text = log_text(rng, chunk)
    nseg = -(-chunk // 32)
    out = [("random_bytes", enc.compress(rng.integers(0, 256, chunk)
                                         .astype(np.uint8), "huffman",
                                         chunk)),
           ("codes_12bit", enc.compress(np.resize(kraft, chunk), "huffman",
                                        chunk))]
    blob = enc.compress(text, "huffman", chunk)
    comp = blob.comp.copy()
    gaps = comp[0, 5:5 * nseg].reshape(nseg - 1, 5)   # entry 0 stays
    comp[0, 5:5 * nseg] = gaps[rng.permutation(nseg - 1)].reshape(-1)
    out.append(("shuffled_gaps", dataclasses.replace(blob, comp=comp)))
    comp = blob.comp.copy()
    for g in range(3, nseg, 7):
        comp[0, 5 * g + 3] |= 0x80               # negative offsets
    for g in range(5, nseg, 11):
        comp[0, 5 * g:5 * g + 4] = [0, 0, 0, 0x40]   # past the row
    out.append(("bad_offsets", dataclasses.replace(blob, comp=comp)))
    return out


# the epilogues phase 3 fuses into every decode kernel's stores
FUSED_KINDS = (
    ("int8_zero", dict(out_dtype="int8", zero_key="epi_zero"),
     {"epi_zero": np.uint8(8)}),
    ("f32_affine", dict(out_dtype="float32", zero_key="epi_zero",
                        scale_key="epi_scale"),
     {"epi_zero": np.uint8(3), "epi_scale": np.float32(0.173)}),
    ("bf16_affine", dict(out_dtype="bfloat16", zero_key="epi_zero",
                         scale_key="epi_scale"),
     {"epi_zero": np.uint8(3), "epi_scale": np.float32(0.173)}),
)


def bit_view(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def lzss_model(row: bytes, width: int, out_len: int) -> list:
    """What an lzss row decodes to, one element at a time, as the
    reference's pointer doubling resolves it: a match element reads the
    element ``dist`` back, or element 0 where that reaches before the row's
    start; element 0 of a first-token match, and every element of a
    zero-distance match, reads the bytes at its own literal offset.  Reads
    past the row's bytes are zero (its padding)."""
    def byte(p):
        return row[p] if p < len(row) else 0

    def value(p):
        return sum(byte(p + b) << (8 * b) for b in range(width))

    out, pos = [], 0
    while len(out) < out_len:
        c = byte(pos)
        if c < 128:
            out += [value(pos + 1 + j * width) for j in range(c + 1)]
            pos += 1 + (c + 1) * width
            continue
        dist = byte(pos + 1) | byte(pos + 2) << 8
        for j in range(c - 126):
            idx = len(out)
            if dist == 0 or idx == 0:
                out.append(value(pos + 1 + j * width))
            else:
                out.append(out[idx - dist] if idx >= dist else out[0])
        pos += 3
    return out[:out_len]


def lzss_edge_blobs(rng, enc, fmt, width: int):
    """lzss edge rows at one width: (name, blob, expected elements)."""
    dt, top = DT[width], 1 << (8 * width)
    chunk_elems = CHUNK_BYTES // width
    rand = lambda n: rng.integers(0, top, n, dtype=np.uint64) \
        .astype(dt)  # noqa: E731
    block = rand(400)
    arrays = {
        "dist_1": np.full(3000, 7, dt),
        "period_3": np.tile(np.array([11, 250, 3], dt), 2000),
        "literal_128": rand(128 * 9),
        "match_129": np.concatenate([block, block, block]),
        "one_elem_tail": np.resize(np.tile(np.array([5, 6, 7, 8], dt), 9)
                                   .astype(dt), chunk_elems + 1),
        "empty": np.zeros(0, dt),
    }
    out = [(k, enc.compress(a, "lzss", CHUNK_BYTES), a)
           for k, a in arrays.items()]

    def lits(n):
        return [("l", rand(min(128, n - i))) for i in range(0, n, 128)]

    lead = min(65535, chunk_elems - 129)
    hand = {
        # at width 1 the match reaches back exactly 65,535 elements; at 2
        # and 4 the chunk is shorter and it reaches before the row's start
        "dist_65535": lits(lead) + [("m", 129, 65535)],
        "before_start": [("l", rand(3)), ("m", 10, 5), ("l", rand(4)),
                         ("m", 40, 30), ("m", 9, 2)],
        "match_first": [("m", 20, 3), ("l", rand(6)), ("m", 12, 4)],
        "zero_dist": [("l", rand(5)), ("m", 10, 0), ("l", rand(2))],
        # the kernel's 32-token batches
        "chained_matches": [("l", rand(4))]
        + [("m", 2 + i % 4, 1 + i % 4) for i in range(60)],
        "straddles_batch_start": [("l", rand(1)) for _ in range(40)]
        + [("m", 10, 12), ("l", rand(3))],
        "chain_through_3": [("l", rand(1)) for _ in range(32)]
        + [("m", 4, 4)] * 4 + [("l", rand(2))],
        "zero_dist_token_31": [("l", rand(1)) for _ in range(31)]
        + [("m", 5, 0), ("l", rand(2))],
        "zero_dist_token_32": [("l", rand(1)) for _ in range(32)]
        + [("m", 5, 0), ("l", rand(2))],
        # 128-element literal runs (513 bytes at width 4) across the ring
        "literal_128_runs": lits(128 * 40) + [("m", 129, 300)],
    }
    for k, tokens in hand.items():
        row = enc.encode_lzss_tokens(tokens, width)
        n = sum(len(t[1]) if t[0] == "l" else t[1] for t in tokens)
        out.append((k, row_blob(fmt, "lzss", row, width, n), lzss_model(
            row, width, n)))
    # a stream cut short: the row ends inside a token, the rest reads zeros
    n = min(2000, chunk_elems)
    full = enc.encode_lzss_chunk(np.tile(rand(50), 40)[:n], width)
    row = full[:len(full) // 2 + 1]
    out.append(("cut_short", row_blob(fmt, "lzss", row, width, n),
                lzss_model(row, width, n)))
    # rows that end inside a literal run and inside a match's distance
    full = enc.encode_lzss_tokens(
        [("l", rand(100)), ("m", 20, 3), ("l", rand(50))], width)
    for k, cut in (("cut_in_literal", 60), ("cut_in_distance",
                                             1 + 100 * width + 2)):
        out.append((k, row_blob(fmt, "lzss", full[:cut], width, 400),
                    lzss_model(full[:cut], width, 400)))
    return [(k, b, np.asarray(w, np.uint64).astype(dt)) for k, b, w in out]


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


CARD = {"label": ""}                # nvidia-smi's name and power limit


def phase_env() -> None:
    log(f"== 1 environment: python {sys.version.split()[0]}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    CARD["label"] = smi.stdout.strip().splitlines()[0]
    log(CARD["label"])


# A second interpreter on phase 2's compile cache: binds every library
# (argv: the package's directory, the cache) and reports its nvcc count.
BIND_CHILD = """
import json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, sys.argv[1])
from repro_torch.core import tuning
from repro_torch.kernels import (bitpack, cuda_build, cuda_rle, huffman,
                                 lzss, scalar, tdeflate)
from repro_torch.kernels import dequant_matmul as dq
tuning.enable_compile_cache(sys.argv[2])
t1 = time.perf_counter()
libs = [cuda_rle.LIB, *cuda_rle.LIB_EPI.values(), bitpack.LIB, tdeflate.LIB,
        huffman.LIB, lzss.LIB, dq.LIB, scalar.LIB]
for x in libs + [dq.WGMMA, scalar.TDEFLATE, scalar.LZSS, scalar.HUFFMAN,
                 scalar.BITPACK, bitpack.REDUCE]:
    x.fn()
print(json.dumps({"import_s": t1 - t0, "bind_s": time.perf_counter() - t1,
                  "nvcc": cuda_build.NVCC_RUNS, "libs": len(libs)}))
"""


def phase_build(cuda_build, tuning, libs, entries, src: Path) -> None:
    """Build every library into a fresh compile cache, bind them, then bind
    them again from a second interpreter on the same cache."""
    (ROOT / "build").mkdir(exist_ok=True)
    cache = tuning.enable_compile_cache(
        tempfile.mkdtemp(prefix="compile-cache-", dir=ROOT / "build"))
    t0 = time.perf_counter()
    paths = cuda_build.build_all(libs)
    dt = time.perf_counter() - t0
    log(f"== 2 kernel build: {', '.join(p.name for p in paths)} in "
        f"{dt:.2f} s (one nvcc each, in parallel)")
    for lib in libs:
        name = " ".join((lib.source.name,) + lib.flags)
        log(f"   {name}: nvcc {lib.build_seconds:.2f} s")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"   {name} ptxas: {line.strip()}")
    t0 = time.perf_counter()
    for x in (*libs, *entries):
        x.fn()
    bind_s = time.perf_counter() - t0
    log(f"   compile cache {cache.relative_to(ROOT)}: "
        f"{cuda_build.NVCC_RUNS} nvcc in this process; cold: build "
        f"{dt:.2f} s, then bind {len(libs)} libraries in {bind_s:.3f} s")
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, "-c", BIND_CHILD, str(src),
                            str(cache)], capture_output=True, text=True,
                           timeout=300)
    wall = time.perf_counter() - t0
    if child.returncode:
        raise AssertionError(f"second process on the cache failed:\n"
                             f"{child.stderr[-2000:]}")
    rec = json.loads(child.stdout.strip().splitlines()[-1])
    log(f"   warm: a second process on the same cache, wall {wall:.2f} s "
        f"(imports {rec['import_s']:.2f} s, bind {rec['libs']} libraries "
        f"{rec['bind_s']:.3f} s), nvcc {rec['nvcc']}")
    if rec["nvcc"] != 0 or rec["libs"] != len(libs):
        raise AssertionError(f"the second process ran {rec['nvcc']} nvcc "
                             "on a filled cache")


def check_rows(name, out, blobs_and_wants, fmt) -> None:
    """Each blob's rows of a decoded table against what it must decode to."""
    host = out.cpu().numpy()
    row = 0
    for key, b, want in blobs_and_wants:
        got = fmt.reassemble(b, host[row:row + b.num_chunks].copy())
        if not np.array_equal(got.reshape(-1).view(np.uint8),
                              np.ascontiguousarray(want).reshape(-1)
                              .view(np.uint8)):
            raise AssertionError(f"{name} {key}: kernel output differs from "
                                 "the input")
        row += b.num_chunks


def decode_pair(codec, dev, *, width, chunk_elems, bits, registry, harness):
    """(kernel output, plain output) of one staged table, on the card."""
    spec = registry.get(codec).decode
    inputs = spec.chunk_inputs(dev)
    lens = dev["out_lens"]
    consts = harness.consts_on(spec, lens.device)
    kw = dict(chunk_elems=chunk_elems, width=width, bits=bits)
    kern = spec.cuda(inputs, consts, lens, **kw)
    plain = spec.body(inputs, consts, lens, **kw)
    torch.cuda.synchronize()
    return kern, plain


def fused_errs(codec, dev, plain, *, width, chunk_elems, bits, registry,
               harness, counter):
    """Each of FUSED_KINDS through the kernel's stores against the plain
    version's output ``plain`` followed by ``Epilogue.apply``, on the card:
    the largest bit difference, after checking one launch and one fused
    epilogue each."""
    spec = registry.get(codec).decode
    worst = 0
    for name, kw, operands in FUSED_KINDS:
        d = {**dev, **{k: torch.from_numpy(np.asarray(v)).to(
            dev["out_lens"].device) for k, v in operands.items()}}
        epi = harness.Epilogue(**kw)
        want = epi.apply(plain, d)
        before = (counter.read(), harness.EPILOGUE_FUSED,
                  harness.EPILOGUE_UNFUSED)
        got = harness.run(spec, d, width=width, chunk_elems=chunk_elems,
                          backend="cuda", bits=bits, epilogue=epi)
        torch.cuda.synchronize()
        after = (counter.read(), harness.EPILOGUE_FUSED,
                 harness.EPILOGUE_UNFUSED)
        if after != (before[0] + 1, before[1] + 1, before[2]):
            raise AssertionError(f"{codec} {name}: launches / fused / "
                                 f"unfused went {before} -> {after}")
        if got.dtype != want.dtype:
            raise AssertionError(f"{codec} {name}: {got.dtype} != "
                                 f"{want.dtype}")
        worst = max(worst, max_abs_err(bit_view(got), bit_view(want)))
    return worst


def phase_kernel_vs_plain(rng, fmt, enc, registry, harness, errs,
                          device, counters) -> None:
    log("== 3 kernels vs plain versions on the card (bit-exact)")
    pair = dict(registry=registry, harness=harness)
    kinds = ", ".join(k for k, _, _ in FUSED_KINDS)
    for codec in ("rle_v1", "rle_v2", "dbp"):
        for width in (1, 2, 4):
            chunk_elems = CHUNK_BYTES // width
            dt = DT[width]
            moderate = runs(rng, rng.integers(0, 200, 64 * chunk_elems // 20)
                            .astype(dt), 40, 64 * chunk_elems)
            arrays = {"moderate_64": moderate,
                      **edge_arrays(rng, width, chunk_elems)}
            rows = [(k, enc.compress(a, codec, CHUNK_BYTES), a)
                    for k, a in arrays.items()]
            for k, groups in rle_ring_rows(rng, codec, width):
                row, want = enc.encode_rle_groups(codec, groups, width)
                rows.append((k, row_blob(fmt, codec, row, width, want.size),
                             want.astype(dt)))
            if codec == "dbp":
                rows.append(("groups_256_bits_32",
                             *dbp_wide_groups(rng, fmt, width)))
                rows += dbp_malformed(rng, fmt, width)
            table = fmt.concat_blobs([b for _, b, _ in rows])
            dev = fmt.to_device(table, device)
            kern, plain = decode_pair(codec, dev, width=width,
                                      chunk_elems=chunk_elems, bits=0, **pair)
            err = max(max_abs_err(kern, plain), fused_errs(
                codec, dev, plain, width=width, chunk_elems=chunk_elems,
                bits=0, counter=counters[kernel_of(codec)], **pair))
            errs[kernel_of(codec)] = max(errs[kernel_of(codec)], err)
            if err:
                raise AssertionError(f"{codec} w{width}: kernel differs "
                                     f"from plain by {err}")
            check_rows(f"{codec} w{width}", kern, rows, fmt)
            cap = ""
            if codec != "dbp":      # dbp's cap, out_len + 4, never binds
                for chunk in (64, 56, 58):  # caps of 36, 32 and 33 groups
                    cap_err = group_cap_err(rng, fmt, codec, width, device,
                                            pair, chunk)
                    if cap_err:
                        raise AssertionError(
                            f"{codec} w{width}: group-cap rows (chunk "
                            f"{chunk}) differ by {cap_err}")
                cap = "; group-cap rows (caps 36, 32, 33) max_abs_err 0"
            log(f"   {codec} w{width}: {table.num_chunks} rows x "
                f"{chunk_elems} elems, kernel == plain (max_abs_err {err}), "
                f"rows == inputs ({', '.join(k for k, _, _ in rows)}){cap}; "
                f"fused {kinds} == plain + Epilogue.apply (bit for bit)")
    for bits in (1, 4, 7, 8, 9, 17, 32):
        for width in (w for w in (1, 2, 4) if bits <= 8 * w):
            chunk_elems = CHUNK_BYTES // width
            top = 1 << bits
            arrays = {
                "random_8": rng.integers(0, top, 8 * chunk_elems,
                                         dtype=np.uint64).astype(DT[width]),
                "one_elem_tail": rng.integers(0, top, chunk_elems + 1,
                                              dtype=np.uint64)
                .astype(DT[width]),
                "all_max": np.full(1000, top - 1, np.uint64).astype(DT[width]),
            }
            rows = [(k, enc.compress(a, "bitpack", CHUNK_BYTES, bits=bits), a)
                    for k, a in arrays.items()]
            tables = [(chunk_elems, rows)]
            # tail rows: 1,000 elements a chunk (a partial last vector)
            tail = rng.integers(0, top, 2500, dtype=np.uint64) \
                .astype(DT[width])
            tables.append((1000, [("chunk_1000", enc.compress(
                tail, "bitpack", 1000 * width, bits=bits), tail)]))
            if bits == 4 and width == 1:     # the weight layout
                q = rng.integers(0, 16, 2 * 65536 + 300).astype(np.uint8)
                tables.append((65536, [("weights_65536", enc.compress(
                    q, "bitpack", 65536, bits=4), q)]))
            for ce, rows in tables:
                table = fmt.concat_blobs([b for _, b, _ in rows])
                dev = fmt.to_device(table, device)
                kern, plain = decode_pair("bitpack", dev, width=width,
                                          chunk_elems=ce, bits=bits, **pair)
                err = max_abs_err(kern, plain)
                err = max(err, fused_errs(
                    "bitpack", dev, plain, width=width, chunk_elems=ce,
                    bits=bits, counter=counters["bitpack_unpack"], **pair))
                errs["bitpack_unpack"] = max(errs["bitpack_unpack"], err)
                if err:
                    raise AssertionError(f"bitpack b{bits} w{width} chunk "
                                         f"{ce}: kernel differs from plain "
                                         f"by {err}")
                check_rows(f"bitpack b{bits} w{width}", kern, rows, fmt)
        log(f"   bitpack b{bits}: widths "
            f"{[w for w in (1, 2, 4) if bits <= 8 * w]}, chunks of "
            f"{CHUNK_BYTES} bytes and of 1,000 elements"
            + (" and the 65,536-element weight layout" if bits == 4 else "")
            + f", kernel == plain (max_abs_err 0), rows == inputs; fused "
            f"{kinds} == plain + Epilogue.apply (bit for bit)")
    chunk = TD_EDGE_CHUNK
    rows = tdeflate_edge_blobs(rng, enc, fmt, chunk)
    table = fmt.concat_blobs([b for _, b, _ in rows])
    dev = fmt.to_device(table, device)
    t0 = time.perf_counter()
    kern, plain = decode_pair("tdeflate", dev, width=1, chunk_elems=chunk,
                              bits=0, **pair)
    plain_s = time.perf_counter() - t0
    err = max(max_abs_err(kern, plain), fused_errs(
        "tdeflate", dev, plain, width=1, chunk_elems=chunk, bits=0,
        counter=counters["tdeflate_decode"], **pair))
    errs["tdeflate_decode"] = max(errs["tdeflate_decode"], err)
    if err:
        raise AssertionError(f"tdeflate: kernel differs from plain by {err}")
    check_rows("tdeflate", kern, rows, fmt)
    log(f"   tdeflate: {table.num_chunks} rows x {chunk} bytes, kernel == "
        f"plain (max_abs_err {err}; plain {plain_s:.1f} s), rows == "
        f"expected ({', '.join(k for k, _, _ in rows)}); fused {kinds} == "
        "plain + Epilogue.apply (bit for bit)")
    rows = [(k, enc.compress(a, "huffman", CHUNK_BYTES), a)
            for k, a in huffman_edge_arrays(rng, CHUNK_BYTES).items()]
    table = fmt.concat_blobs([b for _, b, _ in rows])
    dev = fmt.to_device(table, device)
    kern, plain = decode_pair("huffman", dev, width=1,
                              chunk_elems=CHUNK_BYTES, bits=0, **pair)
    err = max_abs_err(kern, plain)
    err = max(err, fused_errs("huffman", dev, plain, width=1,
                              chunk_elems=CHUNK_BYTES, bits=0,
                              counter=counters["huffman_decode"], **pair))
    errs["huffman_decode"] = max(errs["huffman_decode"], err)
    if err:
        raise AssertionError(f"huffman: kernel differs from plain by {err}")
    check_rows("huffman", kern, rows, fmt)
    tile = huffman_tile_rows(rng, enc, CHUNK_BYTES)
    dev = fmt.to_device(fmt.concat_blobs([b for _, b in tile]), device)
    kern, plain = decode_pair("huffman", dev, width=1,
                              chunk_elems=CHUNK_BYTES, bits=0, **pair)
    tile_err = max(max_abs_err(kern, plain), fused_errs(
        "huffman", dev, plain, width=1, chunk_elems=CHUNK_BYTES, bits=0,
        counter=counters["huffman_decode"], **pair))
    errs["huffman_decode"] = max(errs["huffman_decode"], tile_err)
    if tile_err:
        raise AssertionError(f"huffman tile rows: kernel differs from plain "
                             f"by {tile_err}")
    log(f"   huffman: {table.num_chunks} rows x {CHUNK_BYTES} bytes, kernel "
        f"== plain (max_abs_err {err}), rows == inputs "
        f"({', '.join(k for k, _, _ in rows)}); rows off the staged tile "
        f"({', '.join(k for k, _ in tile)}) kernel == plain (max_abs_err "
        f"{tile_err}); fused {kinds} == plain + Epilogue.apply (bit for "
        "bit)")
    for width in (1, 2, 4):
        rows = lzss_edge_blobs(rng, enc, fmt, width)
        table = fmt.concat_blobs([b for _, b, _ in rows])
        dev = fmt.to_device(table, device)
        t0 = time.perf_counter()
        kern, plain = decode_pair("lzss", dev, width=width,
                                  chunk_elems=CHUNK_BYTES // width, bits=0,
                                  **pair)
        plain_s = time.perf_counter() - t0
        err = max(max_abs_err(kern, plain), fused_errs(
            "lzss", dev, plain, width=width, chunk_elems=CHUNK_BYTES // width,
            bits=0, counter=counters["lzss_decode"], **pair))
        errs["lzss_decode"] = max(errs["lzss_decode"], err)
        if err:
            raise AssertionError(f"lzss w{width}: kernel differs from plain "
                                 f"by {err}")
        check_rows(f"lzss w{width}", kern, rows, fmt)
        log(f"   lzss w{width}: {table.num_chunks} rows x "
            f"{CHUNK_BYTES // width} elems, kernel == plain (max_abs_err "
            f"{err}; plain {plain_s:.1f} s), rows == expected "
            f"({', '.join(k for k, _, _ in rows)}); fused {kinds} == plain "
            "+ Epilogue.apply (bit for bit)")


def phase_dequant_vs_plain(rng, dq, errs, device) -> None:
    """The dequant matmul kernel against its plain version (float32, no
    TF32): bf16 on the tensor-core path at qwen3-1.7B shapes (a split-K
    decode batch among them), M = 1 and M = 64; the SIMT path at the
    reference test's f32 shapes and a bf16 shape TMA cannot describe
    (N % 16 != 0)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    bf = torch.bfloat16
    cases = [((128, 2048, 6144), bf, "wgmma"),
             ((2048, 6144, 2048), bf, "wgmma"),
             ((128, 2048, 1024), bf, "wgmma"), ((1, 2048, 2048), bf, "wgmma"),
             ((64, 2048, 2048), bf, "wgmma"),
             ((256, 2048, 1024), bf, "wgmma"),
             ((128, 128, 128), torch.float32, "simt"),
             ((256, 384, 256), torch.float32, "simt"),
             ((128, 512, 384), torch.float32, "simt"),
             ((64, 96, 100), bf, "simt")]
    for (m, k, n), dtype, path in cases:
        x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)) \
            .to(device).to(dtype)
        q = torch.from_numpy(rng.integers(-127, 127, (k, n)).astype(np.int8))\
            .to(device)
        s = torch.from_numpy((np.abs(rng.normal(size=(1, n))) * 0.01)
                             .astype(np.float32)).to(device)
        before = dict(dq.LAUNCHES_BY_PATH)
        got = dq.dequant_matmul(x, q, s)
        want = dq.ref_dequant_matmul(x, q, s)
        torch.cuda.synchronize()
        took = [p for p, v in dq.LAUNCHES_BY_PATH.items() if v != before[p]]
        if took != [path]:
            raise AssertionError(f"dequant_matmul ({m},{k},{n}) {dtype} took "
                                 f"{took}, expected {path}")
        rtol, atol = TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
        err = float((got.float() - want.float()).abs().max())
        errs["dequant_matmul"] = max(errs["dequant_matmul"], err)
        _, bm, splits = dq._launch_plan(m, n, k, dtype)
        log(f"   dequant_matmul (M,K,N)=({m},{k},{n}) {dtype}: {path} path"
            + (f" (bm {bm}, {splits} K splits)" if path == "wgmma" else "")
            + f", within rtol {rtol} atol {atol} of plain (max_abs_err "
            f"{err:.3g})")


def group_cap_err(rng, fmt, codec, width, device, pair, chunk: int) -> int:
    """Rows of one-literal groups, more than ``max_groups`` (chunk // 2 + 4)
    admits: the last admitted group must cover every lane up to out_len, as
    in the reference's lane->group map.  No encoder writes such rows, so
    they are built here, on a ``chunk``-element chunk (the cap lands at
    group 32 of a 56-element chunk, the last of the kernel's first batch,
    and at group 33 of a 58-element one); returns the kernel's max_abs_err
    against the plain version."""
    hdr = 255 if codec == "rle_v1" else 2 << 6      # one literal
    groups = rng.integers(0, 256, (3, 200, 1 + width)).astype(np.uint8)
    groups[:, :, 0] = hdr
    comp = groups.reshape(3, -1)
    table = fmt.CompressedBlob(
        codec=codec, width=width, chunk_elems=chunk, total_elems=3 * chunk,
        orig_dtype=str(np.dtype(DT[width])), orig_shape=(3 * chunk,),
        comp=comp, comp_lens=np.full(3, comp.shape[1], np.int32),
        out_lens=np.array([chunk, chunk - 14, 7], np.int32))
    kern, plain = decode_pair(codec, fmt.to_device(table, device), width=width,
                              chunk_elems=chunk, bits=0, **pair)
    return max_abs_err(kern, plain)


def build_stage_parts(plan_mod, fmt, ops, transfers, flat, device) -> None:
    """``DecodePlan.build`` and ``stage`` of ``flat`` by part, each cold
    (the first call of these sizes in the process) and warm (the second),
    on the host clock.  build: the whole call, then its parts again apart,
    grouping (``group_key``) and merging (``concat_blobs``).  stage: the
    scatter tables (``reassemble_indices``, uploaded where a blob's rows are
    not contiguous) and the chunk tables (the padded copy and the h2d
    upload, ``ops.table_inputs``), each part ending in a device
    synchronisation.  It calls only functions that every version of the
    port has, so another checkout's package is timed alike (``--stage-only
    --src``)."""
    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        plan = plan_mod.DecodePlan.build(flat)
        t1 = time.perf_counter()
        by_key = {}
        for i, b in enumerate(flat):
            by_key.setdefault(fmt.group_key(b), []).append(i)
        t2 = time.perf_counter()
        merged = [fmt.concat_blobs([flat[i] for i in ids])
                  for ids in by_key.values()]
        t3 = time.perf_counter()
        del merged
        with transfers.count_host_transfers() as c_scat:
            scat = [transfers.to_device(idx, device) for g in plan.groups
                    for idx in g.scatter if idx is not None]
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        with transfers.count_host_transfers() as c_tab:
            staged = [ops.table_inputs(g.merged, device) for g in plan.groups]
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        del plan, scat, staged
        torch.cuda.empty_cache()
        tab_ms = (t5 - t4) * 1e3
        log(f"   {run}: DecodePlan.build {(t1 - t0) * 1e3:.2f} ms (apart: "
            f"grouping {(t2 - t1) * 1e3:.2f} ms, concat_blobs "
            f"{(t3 - t2) * 1e3:.2f} ms); stage {(t5 - t3) * 1e3:.2f} ms = "
            f"scatter tables {(t4 - t3) * 1e3:.2f} ms ({c_scat['h2d']} "
            f"uploads) + chunk tables {tab_ms:.2f} ms ({c_tab['h2d']} "
            f"uploads, {c_tab['h2d_bytes'] / 2**20:.1f} MiB, "
            f"{c_tab['h2d_bytes'] / tab_ms / 1e6:.2f} GB/s host to card)")


def staged_decode(plan_mod, transfers, plan, engine, reps: int) -> tuple:
    """Stage ``plan`` (host clock, uploads counted), run ``execute_device``
    once keeping each group's decoded table on the host (the raw matrix of
    the group's one dispatch), then time the staged decode under the
    no-host-transfer guard.  Returns (stage ms, the upload counts, the
    tables in group order, decode ms)."""
    t0 = time.perf_counter()
    with transfers.count_host_transfers() as h2d:
        plan.stage(engine.device)
    torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) * 1e3
    tables, dispatch = [], plan_mod.dispatch

    def keep(*a, **kw):
        out = dispatch(*a, **kw)
        tables.append(out.cpu())
        return out

    plan_mod.dispatch = keep
    try:
        plan.execute_device(engine)
    finally:
        plan_mod.dispatch = dispatch
    torch.cuda.synchronize()

    def run_staged():
        with transfers.no_host_transfers():
            plan.execute_device(engine)

    return stage_ms, h2d, tables, ms_of(run_staged, reps)


def main_data(args, rng, api):
    """Phase 4's workload (§ the module docstring): the arrays, their
    ``CompressedArray``s, the distinct columns, and the texts' arrays."""
    target = int(args.gib * (1 << 30))
    t0 = time.perf_counter()
    n_text = int(args.text_mib * (1 << 20))
    text, tokens = log_corpus(rng, n_text, n_text // 4)
    [text_ca] = api.compress_many([text], "tdeflate", CHUNK_BYTES)
    text_s = time.perf_counter() - t0
    text_copies = -(-args.td_chunks // text_ca.blobs[0].num_chunks)
    t0 = time.perf_counter()
    [hf_ca] = api.compress_many([text], "huffman", CHUNK_BYTES)
    hf_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    [lz_ca] = api.compress_many([tokens], "lzss", CHUNK_BYTES)
    lz_s = time.perf_counter() - t0
    hf_copies = -(-args.ent_chunks // hf_ca.blobs[0].num_chunks)
    lz_copies = -(-args.ent_chunks // lz_ca.blobs[0].num_chunks)
    rest = max(1 << 20, target - text_copies * text.nbytes)
    col_bytes = min(32 << 20, max(1 << 20, rest // 30))
    t0 = time.perf_counter()
    cols = scan_columns(rng, col_bytes)
    distinct = api.compress_many([a for _, a, _ in cols],
                                 [c for _, _, c in cols], CHUNK_BYTES)
    encode_s = time.perf_counter() - t0
    per_copy = sum(a.nbytes for _, a, _ in cols)
    copies = -(-rest // per_copy)
    arrays = ([a for _, a, _ in cols] * copies + [text] * text_copies
              + [text] * hf_copies + [tokens] * lz_copies)
    cas = (distinct * copies + [text_ca] * text_copies + [hf_ca] * hf_copies
           + [lz_ca] * lz_copies)
    log(f"   {len(cols)} distinct columns ({per_copy / 2**20:.0f} MiB, "
        f"encoded in {encode_s:.1f} s) listed {copies}x, and "
        f"{text.nbytes / 2**20:.1f} MiB of log text (tdeflate ratio "
        f"{text_ca.ratio:.4f}, encoded in {text_s:.1f} s) listed "
        f"{text_copies}x; the same text through huffman (ratio "
        f"{hf_ca.ratio:.4f}, {hf_s:.1f} s) listed {hf_copies}x, and its "
        f"{tokens.size} u32 token ids through lzss (ratio {lz_ca.ratio:.4f}, "
        f"{lz_s:.1f} s) listed {lz_copies}x: {len(cas)} arrays, "
        f"{sum(len(ca.blobs) for ca in cas)} blobs")
    return dict(arrays=arrays, cas=cas, cols=cols, distinct=distinct,
                text=text, tokens=tokens, text_ca=text_ca, hf_ca=hf_ca,
                lz_ca=lz_ca)


def phase_main(args, rng, api, plan_mod, transfers, registry, harness,
               kmods, counters, engine, errs):
    from repro_torch.roofline import analysis
    log("== 4 main path: compress_many -> decompress_many(device_out=True) "
        "on cuda")
    data = main_data(args, rng, api)
    arrays, cas = data["arrays"], data["cas"]
    out_bytes = sum(a.nbytes for a in arrays)
    comp_bytes = sum(ca.compressed_bytes for ca in cas)
    flat = [b for ca in cas for b in ca.blobs]
    log("   DecodePlan.build and stage by part (host clock):")
    build_stage_parts(plan_mod, kmods["fmt"], kmods["ops"], transfers, flat,
                      engine.device)
    t0 = time.perf_counter()
    plan = plan_mod.DecodePlan.build(flat)
    build_ms = (time.perf_counter() - t0) * 1e3
    n_groups = plan.num_dispatches
    log(f"   {plan.num_chunks} chunks, {n_groups} groups")

    # one call through the user's entry point, counted
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    outs = api.decompress_many(cas, engine, device_out=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: c.read() for k, c in counters.items()}
    if sum(launches.values()) != n_groups:
        raise AssertionError(f"kernel launches grew by "
                             f"{sum(launches.values())}, expected {n_groups}"
                             " (one per plan group)")
    missing = [k for k, v in launches.items()
               if v < 1 and k != "dequant_matmul"]
    if missing:
        raise AssertionError(f"not launched on the main path: {missing}")
    log(f"   launches grew by {sum(launches.values())} == {n_groups} plan "
        f"groups {launches}; first call {first_s * 1e3:.1f} ms (plan build, "
        "staging, decode)")
    # checked on the host only now, after the counted call
    for i, (a, o) in enumerate(zip(arrays, outs)):
        if o.device != engine.device:
            raise AssertionError(f"array {i} came back on {o.device}")
        got = o.cpu().numpy()
        if got.dtype != a.dtype or not np.array_equal(got, a):
            raise AssertionError(f"array {i} ({a.dtype}) differs from input")
    log(f"   {len(outs)} arrays bit-exact against the numpy inputs")
    del outs

    # end-to-end call time (host clock; includes plan build and staging)
    e2e = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        o = api.decompress_many(cas, engine, device_out=True)
        torch.cuda.synchronize()
        e2e.append(time.perf_counter() - t0)
        del o
    # decode time of a staged plan, under the no-host-transfer guard; each
    # group's decoded table kept on the host for phase 20
    stage_ms, h2d, tables, dec_ms = staged_decode(plan_mod, transfers, plan,
                                                  engine, args.reps)
    data["ops_ref"] = dict(tables=tables, build_ms=build_ms,
                           stage_ms=stage_ms, decode_ms=dec_ms,
                           e2e_ms=float(np.median(e2e)) * 1e3)
    bound = sum(analysis.decode_bound_ms(
                    g.key[0], int(g.merged.comp_lens.sum()), g.num_chunks,
                    g.key[2], g.key[1])
                for g in plan.groups)
    log(f"   output {out_bytes / 2**30:.3f} GiB, compressed "
        f"{comp_bytes / 2**20:.1f} MiB (ratio {comp_bytes / out_bytes:.4f})")
    log(f"   decompress_many end to end: median "
        f"{np.median(e2e) * 1e3:.2f} ms over {args.reps}; of one call, "
        f"DecodePlan.build {build_ms:.2f} ms and stage {stage_ms:.2f} ms "
        f"({h2d['h2d']} uploads, {h2d['h2d_bytes'] / 2**20:.1f} MiB; host "
        "clock, once each)")
    log(f"   staged decode (execute_device, no host transfers): median "
        f"{dec_ms:.3f} ms over {args.reps} = "
        f"{out_bytes / dec_ms / 1e6:.1f} GB/s of output; bytes bound "
        f"{bound:.3f} ms ({bound / dec_ms * 100:.1f}% of it)")
    log("   library_ms: null for every decode kernel: no single PyTorch "
        "call decodes RLE, dbp, bitpack, Deflate-semantics, Huffman or LZSS "
        "streams")

    # per plan group: kernel time, plain version time, bound, on the main
    # path's own staged tables
    per = {k: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "plain_rows": 0} for k in KERNELS}
    for gi, g in enumerate(plan.groups):
        codec, width, chunk_elems, bits = g.key
        dev = plan._staged[engine.device][gi]
        spec = registry.get(codec).decode
        inputs = spec.chunk_inputs(dev)
        lens = dev["out_lens"]
        consts = harness.consts_on(spec, lens.device)
        kw = dict(chunk_elems=chunk_elems, width=width, bits=bits)
        cap = {"tdeflate": args.td_plain_rows, "lzss": args.lz_plain_rows}
        rows = min(g.num_chunks, cap.get(codec, g.num_chunks))
        out_k = spec.cuda(inputs, consts, lens, **kw)[:rows]   # also warms
        k_ms = ms_of(lambda: spec.cuda(inputs, consts, lens, **kw), args.reps)
        d_ms = device_ms(lambda: spec.cuda(inputs, consts, lens, **kw),
                         args.reps)
        cut = tuple(t[:rows] for t in inputs)
        res = {}
        plain_ms = ms_of(lambda: res.update(
            p=spec.body(cut, consts, lens[:rows], **kw)), 1)
        err = max_abs_err(out_k, res.pop("p"))
        del out_k
        torch.cuda.empty_cache()
        name = kernel_of(codec)
        errs[name] = max(errs[name], err)
        b = analysis.decode_bound_ms(codec, int(g.merged.comp_lens.sum()),
                                     g.num_chunks, chunk_elems, width)
        per[name]["ms"] += k_ms
        per[name]["device_ms"] += d_ms
        per[name]["plain_ms"] += plain_ms
        per[name]["bound_ms"] += b
        per[name]["plain_rows"] += rows
        extra = ""
        if codec in kmods["cuda_rle"].CODEC_IDS:
            grp = torch.zeros(g.num_chunks, dtype=torch.int32,
                              device=lens.device)
            kmods["cuda_rle"].decode(codec, inputs[0], lens,
                                     chunk_elems=chunk_elems, width=width,
                                     groups=grp)
            mean = float(grp.to(torch.float64).mean())
            ns = k_ms * 1e6 / max(1.0, mean * g.num_chunks)
            extra = (f", groups per chunk mean {mean:.1f} max "
                     f"{int(grp.max())} ({ns:.3f} ns a group)")
        if codec in ("tdeflate", "lzss"):
            tok = torch.zeros(g.num_chunks, dtype=torch.int32,
                              device=lens.device)
            if codec == "tdeflate":
                kmods["tdeflate"].decode(inputs[0], inputs[1:], consts, lens,
                                         chunk_elems=chunk_elems, tokens=tok)
            else:
                kmods["lzss"].decode(inputs[0], lens, chunk_elems=chunk_elems,
                                     width=width, tokens=tok)
            mean = float(tok.to(torch.float64).mean())
            rate = mean * g.num_chunks / k_ms / 1e6
            extra = (f", tokens per chunk mean {mean:.1f} max "
                     f"{int(tok.max())} ({rate:.3f} G tokens/s)")
        log(f"   group {g.key}: {g.num_chunks} chunks, kernel {k_ms:.3f} ms "
            f"(device {d_ms:.3f} ms), bound {b:.3f} ms "
            f"({b / k_ms * 100:.1f}%), plain {plain_ms:.1f} "
            f"ms on {rows} rows, max_abs_err {err}{extra}")
        if err:
            raise AssertionError(f"group {g.key}: kernel differs from plain")
    data["plan"] = plan
    return launches, per, data


def phase_epilogue(args, api, fmt, registry, harness, engine, data) -> None:
    """Epilogues through ``decompress_many`` against their plain torch
    versions (each fused, in the kernel's stores), then the fused decode
    timed against the kernel followed by ``Epilogue.apply``."""
    log("== 5 epilogues against their plain torch versions")
    dev = engine.device

    def operands_on(operands):
        return {k: torch.from_numpy(np.asarray(v)).to(dev)
                for k, v in operands.items()}

    def check(name, ca, x, epi, operands):
        before = (harness.EPILOGUE_FUSED, harness.EPILOGUE_UNFUSED)
        [got] = api.decompress_many([ca], engine, device_out=True,
                                    epilogue=epi, epilogue_operands=operands)
        grew = (harness.EPILOGUE_FUSED - before[0],
                harness.EPILOGUE_UNFUSED - before[1])
        if grew != (len(ca.blobs), 0):
            raise AssertionError(f"{name}: fused / unfused epilogues grew by "
                                 f"{grew}")
        out = getattr(torch, epi.out_dtype or "float32")
        x = torch.from_numpy(x).to(dev)
        want = x.to(out)
        if epi.zero_key:
            want = want - torch.tensor(operands[epi.zero_key],
                                       device=dev).to(out)
        if epi.scale_key:
            want = want * torch.tensor(operands[epi.scale_key],
                                       device=dev).to(out)
        if got.dtype != want.dtype or not torch.equal(bit_view(got),
                                                      bit_view(want)):
            raise AssertionError(f"{name}: epilogue output differs from the "
                                 "plain torch version")
        log(f"   {name}: {x.numel()} elements -> {got.dtype}, exact against "
            "the plain torch version (epilogue in the kernel's stores)")

    def timed(name, ca, epi, operands):
        """The fused decode against the kernel followed by Epilogue.apply,
        on the array's staged table (median of ``--reps``)."""
        [blob] = ca.blobs
        d = {**fmt.to_device(blob, dev), **operands_on(operands)}
        spec = registry.get(blob.codec).decode
        bits = registry.get(blob.codec).static_bits(blob)
        kw = dict(width=blob.width, chunk_elems=blob.chunk_elems, bits=bits)
        inputs, lens = spec.chunk_inputs(d), d["out_lens"]
        consts = harness.consts_on(spec, lens.device)

        def fused():
            return harness.run(spec, d, backend="cuda", epilogue=epi, **kw)

        def unfused():
            return epi.apply(spec.cuda(inputs, consts, lens, **kw), d)

        if not torch.equal(bit_view(fused()), bit_view(unfused())):
            raise AssertionError(f"{name}: fused != kernel + Epilogue.apply")
        f_ms, u_ms = ms_of(fused, args.reps), ms_of(unfused, args.reps)
        plain_ms = ms_of(lambda: spec.cuda(inputs, consts, lens, **kw),
                         args.reps)
        out_mib = blob.num_chunks * blob.chunk_elems * blob.width / 2**20
        log(f"   {name}: {blob.num_chunks} chunks ({out_mib:.1f} MiB raw), "
            f"fused {f_ms:.3f} ms vs kernel + Epilogue.apply {u_ms:.3f} ms "
            f"({u_ms / f_ms:.2f}x; the kernel alone {plain_ms:.3f} ms)")

    cols, distinct = data["cols"], data["distinct"]
    names = [n for n, _, _ in cols]
    affine = dict(scale_key="epi_scale", zero_key="epi_zero")
    f32 = harness.Epilogue(out_dtype="float32", **affine)
    bf16 = harness.Epilogue(out_dtype="bfloat16", **affine)
    idx = names.index("flags_u8")
    rle_ops = {"epi_scale": np.float32(0.37), "epi_zero": np.uint8(2)}
    check("rle_v2 u8 column, float32 (x - zero) * scale", distinct[idx],
          cols[idx][1], f32, rle_ops)
    idx16 = names.index("dict_codes_u16")
    check("bitpack 11-bit u16 column, float32 (x - zero) * scale",
          distinct[idx16], cols[idx16][1], f32,
          {"epi_scale": np.float32(0.0123), "epi_zero": np.uint16(1024)})
    text, tokens = data["text"], data["tokens"]
    text_ops = {"epi_scale": np.float32(0.37), "epi_zero": np.uint8(97)}
    check("huffman log text, bf16 (x - zero) * scale", data["hf_ca"], text,
          bf16, text_ops)
    check("tdeflate log text, bf16 (x - zero) * scale", data["text_ca"],
          text, bf16, text_ops)
    tok_ops = {"epi_scale": np.float32(0.5), "epi_zero": np.uint32(3)}
    check("lzss token shard, float32 (x - zero) * scale", data["lz_ca"],
          tokens, f32, tok_ops)
    timed("rle_v2 flags_u8 column, f32 affine", distinct[idx], f32, rle_ops)
    timed("tdeflate log text, bf16 affine", data["text_ca"], bf16, text_ops)
    timed("lzss token shard, f32 affine", data["lz_ca"], f32, tok_ops)
    plan = data["plan"]
    [gi] = [i for i, g in enumerate(plan.groups) if g.key[0] == "tdeflate"]
    fused_at_scale(args, plan, gi, engine, registry, harness,
                   text_ops, bf16, operands_on)


def fused_at_scale(args, plan, gi, engine, registry, harness, operands, epi,
                   operands_on) -> None:
    """tdeflate's fused epilogue against the kernel followed by
    ``Epilogue.apply`` on phase 4's staged tdeflate group (2,048 chunks at
    the default size): equal bit for bit, then each one's device time
    (``device_ms``), the two interleaved, median of ``--reps``."""
    g = plan.groups[gi]
    codec, width, chunk_elems, bits = g.key
    dev = {**plan._staged[engine.device][gi], **operands_on(operands)}
    spec = registry.get(codec).decode
    kw = dict(width=width, chunk_elems=chunk_elems, bits=bits)
    inputs, lens = spec.chunk_inputs(dev), dev["out_lens"]
    consts = harness.consts_on(spec, lens.device)

    def fused():
        return harness.run(spec, dev, backend="cuda", epilogue=epi, **kw)

    def unfused():
        return epi.apply(spec.cuda(inputs, consts, lens, **kw), dev)

    def kernel():
        return spec.cuda(inputs, consts, lens, **kw)

    if not torch.equal(bit_view(fused()), bit_view(unfused())):
        raise AssertionError(f"tdeflate group of {g.num_chunks} chunks: "
                             "fused != kernel + Epilogue.apply")
    kernel()                      # each output's blocks cached once
    times = {"fused": [], "kernel + apply": [], "kernel": []}
    for _ in range(args.reps):
        for name, fn in (("fused", fused), ("kernel + apply", unfused),
                         ("kernel", kernel)):
            times[name].append(device_ms(fn, 1))
    med = {k: float(np.median(v)) for k, v in times.items()}
    out_mib = g.num_chunks * chunk_elems * width / 2**20
    log(f"   tdeflate group of phase 4, bf16 affine: {g.num_chunks} chunks "
        f"({out_mib:.1f} MiB raw), device time, median of {args.reps} "
        f"interleaved: fused {med['fused']:.3f} ms vs kernel + "
        f"Epilogue.apply {med['kernel + apply']:.3f} ms "
        f"({med['kernel + apply'] / med['fused']:.3f}x; the kernel alone "
        f"{med['kernel']:.3f} ms); fused == kernel + Epilogue.apply bit for "
        f"bit; runs fused {', '.join(f'{t:.3f}' for t in times['fused'])}, "
        f"unfused {', '.join(f'{t:.3f}' for t in times['kernel + apply'])}, "
        f"kernel {', '.join(f'{t:.3f}' for t in times['kernel'])} "
        f"[{CARD['label']}]")


def phase_quantized(args, rng, dq, harness, transfers, counters, engine, errs,
                    per) -> dict:
    """decompress_dequant_matmul over every projection of ``--q-layers``
    layers of qwen3-1.7B; returns the path's launch counts."""
    from repro_torch.roofline import analysis
    log("== 6 quantized-weight path: decompress_dequant_matmul, qwen3-1.7B "
        f"widths, {args.q_layers} layers, W4A16")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = engine.device
    t0 = time.perf_counter()
    weights = []      # (name, K, N, CompressedArray, int8 host, scale)
    for layer in range(args.q_layers):
        for name, k, n in QWEN3_PROJECTIONS:
            w = rng.standard_normal((k, n), dtype=np.float32) * np.float32(
                0.02)
            # symmetric per-output-channel int4: [-8, 7]
            scale = np.abs(w).max(axis=0, keepdims=True) / np.float32(7)
            q = np.clip(np.rint(w / scale), -8, 7).astype(np.int8)
            ca = dq.compress_weights(q, "bitpack", zero_point=8)
            weights.append((f"{layer}.{name}", k, n, ca, q,
                            torch.from_numpy(scale).to(dev)))
    enc_s = time.perf_counter() - t0
    raw = sum(q.nbytes for *_, q, _ in weights)
    comp = sum(ca.compressed_bytes for _, _, _, ca, _, _ in weights)
    log(f"   {len(weights)} projections, {raw / 2**20:.1f} MiB of int8 "
        f"weights, {comp / 2**20:.1f} MiB bitpacked at "
        f"{8 * comp / raw:.2f} bits a weight (made and encoded in "
        f"{enc_s:.1f} s)")
    ms_list = Q_BATCHES
    xs = {(m, k): torch.from_numpy(rng.standard_normal((m, k),
                                                       dtype=np.float32))
          .to(dev).to(torch.bfloat16)
          for m in ms_list for k in {k for _, k, _ in QWEN3_PROJECTIONS}}

    # one run of the path through the user's entry point, counted
    for c in counters.values():
        c.reset()
    harness.EPILOGUE_FUSED = harness.EPILOGUE_UNFUSED = 0
    by_path = dict(dq.LAUNCHES_BY_PATH)
    ys = {}
    for m in ms_list:
        for name, k, n, ca, q, s in weights:
            ys[m, name] = dq.decompress_dequant_matmul(
                xs[m, k], ca, s, zero_point=8, engine=engine)
    torch.cuda.synchronize()
    launches = {k: c.read() for k, c in counters.items()}
    want = {k: 0 for k in launches}
    want["dequant_matmul"] = want["bitpack_unpack"] = len(ys)
    if launches != want:
        raise AssertionError(f"quantized path launches {launches}, expected "
                             f"{want}")
    epilogues = (harness.EPILOGUE_FUSED, harness.EPILOGUE_UNFUSED)
    if epilogues != (len(ys), 0):
        raise AssertionError(f"quantized path epilogues (fused, unfused) "
                             f"{epilogues}, expected ({len(ys)}, 0)")
    paths = {p: v - by_path[p] for p, v in dq.LAUNCHES_BY_PATH.items()}
    if paths != {"wgmma": len(ys), "simt": 0}:
        raise AssertionError(f"quantized path took {paths}, expected every "
                             "call on the wgmma path")
    log(f"   {len(ys)} calls (M = {ms_list}): launches dequant_matmul "
        f"{launches['dequant_matmul']} (paths {paths}), bitpack_unpack "
        f"{launches['bitpack_unpack']}, each weight decode one launch with "
        f"its zero-point epilogue fused ({epilogues[0]} fused, "
        f"{epilogues[1]} unfused epilogue passes)")

    rtol, atol = TOL[torch.bfloat16]
    worst = 0.0
    for name, k, n, ca, q, s in weights:
        qd = dq.decode_weights(ca, zero_point=8, engine=engine)
        if qd.dtype != torch.int8 or not np.array_equal(qd.cpu().numpy(), q):
            raise AssertionError(f"{name}: decoded weights differ")
        for m in ms_list:
            got = ys.pop((m, name)).float()
            ref = dq.ref_dequant_matmul(xs[m, k], qd, s).float()
            torch.testing.assert_close(got, ref, rtol=rtol, atol=atol,
                                       msg=lambda e: f"{name} M={m}: {e}")
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name} M={m}: non-finite output")
            worst = max(worst, float((got - ref).abs().max()))
    errs["dequant_matmul"] = max(errs["dequant_matmul"], worst)
    log(f"   every output finite and within rtol {rtol} atol {atol} of the "
        f"plain version on the decoded weights (max_abs_err {worst:.3g}); "
        "decoded weights == the host int8 weights")

    # steady state: the plan is cached on each CompressedArray
    tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "library_ms": 0.0}
    by = {"bytes": 0.0, "operations": 0.0}
    for m in ms_list:
        acc = {"decode": 0.0, "kernel": 0.0, "plain": 0.0, "library": 0.0,
               "bound": 0.0, "whole": 0.0, "device": 0.0}
        for name, k, n, ca, q, s in weights:
            x = xs[m, k]
            qd = dq.decode_weights(ca, zero_point=8, engine=engine)
            w = (qd.float() * s).to(torch.bfloat16)

            def guarded(fn):
                def run():
                    with transfers.no_host_transfers():
                        fn()
                return run

            fns = {
                "decode": guarded(lambda: dq.decode_weights(
                    ca, zero_point=8, engine=engine)),
                "kernel": guarded(lambda: dq.dequant_matmul(x, qd, s)),
                "whole": guarded(lambda: dq.decompress_dequant_matmul(
                    x, ca, s, zero_point=8, engine=engine)),
                "plain": lambda: dq.ref_dequant_matmul(x, qd, s),
                "library": lambda: torch.matmul(x, w),
            }
            t = {}
            for key, fn in fns.items():
                fn()                    # warm: cuBLAS picks its algorithm
                t[key] = ms_of(fn, args.reps)
            t["device"] = device_ms(fns["kernel"], args.reps)
            b, what = analysis.matmul_bound(m, n, k, x.element_size())
            t["bound"] = b
            by[what] += b
            for key, v in t.items():
                acc[key] += v
            if name.startswith("0."):
                log(f"   M={m} {name} (K,N)=({k},{n}): decode "
                    f"{t['decode']:.4f} ms, kernel {t['kernel']:.4f} ms, "
                    f"decode+kernel {t['whole']:.4f} ms, plain "
                    f"{t['plain']:.4f} ms, torch.matmul {t['library']:.4f} "
                    f"ms, bound {b:.4f} ms ({what}, "
                    f"{b / t['kernel'] * 100:.1f}%)")
        log(f"   M={m}, all {len(weights)} projections (sums of medians of "
            f"{args.reps}): decode {acc['decode']:.3f} ms, kernel "
            f"{acc['kernel']:.3f} ms (device {acc['device']:.3f} ms), "
            f"decode+kernel {acc['whole']:.3f} ms, "
            f"plain {acc['plain']:.3f} ms, torch.matmul {acc['library']:.3f} "
            f"ms, bound {acc['bound']:.3f} ms "
            f"({acc['bound'] / acc['kernel'] * 100:.1f}% of the kernel); "
            "steady state under no_host_transfers()")
        tot["ms"] += acc["kernel"]
        tot["device_ms"] += acc["device"]
        tot["plain_ms"] += acc["plain"]
        tot["bound_ms"] += acc["bound"]
        tot["library_ms"] += acc["library"]
        log(f"   M={m}: kernel / torch.matmul = "
            f"{acc['kernel'] / acc['library']:.2f} (sums of medians)")

    # the weight decode's split: the host clock of the whole decode_weights
    # call (it returns once the launch is queued) against the device time
    # of its launch, by CUDA events with the stream held busy until the
    # launch is queued (so the events see no host gap)
    host, device = [], []
    for _, k, n, ca, _, _ in weights:
        def decode():
            with transfers.no_host_transfers():
                dq.decode_weights(ca, zero_point=8, engine=engine)

        h = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode()
            h.append((time.perf_counter() - t0) * 1e3)
        host.append(float(np.median(h)))
        device.append(device_ms(decode, args.reps))
    packed = sum(ca.compressed_bytes for _, _, _, ca, _, _ in weights)
    decode_bound = (packed + raw) / analysis.HBM_BW * 1e3
    log(f"   weight decode split over all {len(weights)} projections (sums "
        f"of medians of {args.reps}): host clock of decode_weights "
        f"{sum(host):.3f} ms, device time of its launch {sum(device):.3f} "
        f"ms, bytes bound {decode_bound:.3f} ms (packed read + int8 "
        f"written); per projection {sum(host) / len(weights) * 1e3:.1f} us "
        f"host, {sum(device) / len(weights) * 1e3:.1f} us device")
    per["bitpack_unpack"]["weight_decode_host_ms"] = sum(host)
    per["bitpack_unpack"]["weight_decode_device_ms"] = sum(device)

    # one sweep over every projection a rep: the int8 weights (and the
    # bf16 ones of torch.matmul) exceed the L2 cache, so each sweep reads
    # them from device memory, as a serving step does
    decoded = [(dq.decode_weights(ca, zero_point=8, engine=engine), s, k)
               for _, k, _, ca, _, s in weights]
    deq = [(qd.float() * s).to(torch.bfloat16) for qd, s, _ in decoded]
    sweep = {}
    for m in ms_list:
        def kern_sweep():
            for qd, s, k in decoded:
                dq.dequant_matmul(xs[m, k], qd, s)

        def lib_sweep():
            for (_, _, k), w in zip(decoded, deq):
                torch.matmul(xs[m, k], w)

        kern_sweep()
        lib_sweep()
        sweep[m] = (ms_of(kern_sweep, args.reps), ms_of(lib_sweep, args.reps))
        log(f"   M={m}, one sweep over all {len(weights)} projections "
            f"(median of {args.reps}, weights from device memory): kernel "
            f"{sweep[m][0]:.3f} ms, torch.matmul {sweep[m][1]:.3f} ms "
            f"({sweep[m][0] / sweep[m][1]:.2f}x)")
    del decoded, deq
    per["dequant_matmul"].update(
        tot, plain_rows=None, bound_by=max(by, key=by.get),
        sweep_ms=sum(k for k, _ in sweep.values()),
        library_sweep_ms=sum(lib for _, lib in sweep.values()))
    return launches


def expected_planes(a: np.ndarray, n: int) -> list:
    """What each of an array's ``n`` blobs decodes to: the array, or the lo
    and hi uint32 planes of an 8-byte dtype."""
    if n == 1:
        return [a]
    u64 = np.ascontiguousarray(a).reshape(-1).view(np.uint64)
    return [(u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (u64 >> np.uint64(32)).astype(np.uint32)]


def same(got, want: np.ndarray) -> bool:
    if isinstance(got, torch.Tensor):
        got = got.cpu().numpy()
    return got.dtype == want.dtype and np.array_equal(
        np.ascontiguousarray(got).reshape(-1).view(np.uint8),
        np.ascontiguousarray(want).reshape(-1).view(np.uint8))


def phase_service(args, api, fmt, ops, transfers, server, store, engine,
                  data, counters):
    """The serving layer: phase 4's arrays through one DecompressionService
    from 8 producer threads, twice; ``decompress_many`` through the default
    service beside the direct plan path; then a checkpoint-scale restore of
    every blob through the tiered store."""
    log("== 7 service: DecompressionService, default_service, TieredBlobStore")
    arrays, cas = data["arrays"], data["cas"]
    out_bytes = sum(a.nbytes for a in arrays)
    n_threads = 8

    def serve(svc, label):
        """Two passes of every request from ``n_threads`` producers."""
        prev = svc.stats()
        walls = []
        for rnd in (1, 2):
            results = [None] * len(cas)
            failed = []

            def producer(tid):
                try:
                    for i in range(tid, len(cas), n_threads):
                        results[i] = svc.submit_array(
                            cas[i], device_out=i % 2 == 1).result(timeout=600)
                except Exception as e:   # reported below, never swallowed
                    failed.append(f"request {i}: {e!r}")

            threads = [threading.Thread(target=producer, args=(t,))
                       for t in range(n_threads)]
            with transfers.count_host_transfers() as moved:
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(900)
                wall = time.perf_counter() - t0
            if failed or any(t.is_alive() for t in threads):
                raise AssertionError(f"service {label} pass {rnd}: "
                                     f"{failed[:3]}")
            st = svc.stats()
            bad = [i for i, (a, r) in enumerate(zip(arrays, results))
                   if r is None
                   or isinstance(r, torch.Tensor) != (i % 2 == 1)
                   or (isinstance(r, torch.Tensor)
                       and r.device != engine.device)
                   or not same(r, a)]
            if bad or st.errors:
                raise AssertionError(f"service {label} pass {rnd}: arrays "
                                     f"{bad[:5]} differ, {st.errors} errors")
            del results
            w = st.windows - prev.windows
            hits = st.cache_hits - prev.cache_hits
            looks = hits + st.cache_misses - prev.cache_misses
            log(f"   {label} pass {rnd}: {len(cas)} requests "
                f"({len(cas) // 2} device_out) from {n_threads} threads, {w} "
                f"windows, {(st.blobs - prev.blobs) / w:.2f} blobs and "
                f"{(st.dispatches - prev.dispatches) / w:.2f} dispatches a "
                f"window, dispatch amplification "
                f"{(st.dispatches - prev.dispatches) / (st.blobs - prev.blobs):.3f}"
                f", cache hit rate {hits / max(1, looks):.3f}; staged "
                f"{moved['h2d_bytes'] / 2**20:.1f} MiB in {moved['h2d']} "
                f"uploads; wall {wall * 1e3:.1f} ms = "
                f"{out_bytes / wall / 1e9:.2f} GB/s of output; all bit-exact")
            prev = st
            walls.append(wall * 1e3)
        log(f"   {label}, both passes: request latency p50 "
            f"{st.latency_p50_ms:.2f} ms, p99 {st.latency_p99_ms:.2f} ms; "
            f"dispatch amplification {st.dispatch_amplification:.3f}; "
            f"{st.device_dispatches}")
        return walls

    # pow2 buckets (the reference's default) against none, in turns
    # (bucketed, unbucketed, unbucketed, bucketed), a fresh service each:
    # the buckets' padding cost on the card
    for c in counters.values():
        c.reset()
    walls = {True: [], False: []}
    for bucket in (True, False, False, True):
        svc = server.DecompressionService(
            engine, cache_bytes=256 << 20, bucket_shapes=bucket,
            devices=[engine.device])
        walls[bucket].append(serve(
            svc, "bucket_shapes=True" if bucket else "bucket_shapes=False"))
        svc.close(timeout=60)
        if bucket and len(walls[True]) == 1:
            launched = {k: c.read() for k, c in counters.items()}
            missing = [k for k, v in launched.items()
                       if v < 1 and k != "dequant_matmul"]
            if missing:
                raise AssertionError(f"not launched by the service: "
                                     f"{missing}")
            log(f"   launches of the first service: {launched}")
    log("   service wall, pass 1 / pass 2 (ms): bucketed "
        + ", ".join(f"{a:.1f} / {b:.1f}" for a, b in walls[True])
        + "; unbucketed "
        + ", ".join(f"{a:.1f} / {b:.1f}" for a, b in walls[False]))

    # one-shot host decodes: the default service against the direct plan,
    # in turns (service, direct, direct, service), each call's outputs
    # dropped before the next
    ms = {"service": [], "direct": []}
    for path in ("service", "direct", "direct", "service"):
        with ops.count_dispatches() as calls:
            t0 = time.perf_counter()
            outs = (api.decompress_many(cas) if path == "service"
                    else api.decompress_many(cas, engine))
            ms[path].append((time.perf_counter() - t0) * 1e3)
        if len(calls) != len({fmt.group_key(b) for ca in cas
                              for b in ca.blobs}) or not all(
                same(o, a) for o, a in zip(outs, arrays)):
            raise AssertionError(f"decompress_many ({path}): {len(calls)} "
                                 "dispatches, or outputs differ")
        del outs
    log(f"   api.decompress_many(cas) via default_service(): {len(calls)} "
        f"dispatches, {ms['service'][0]:.1f} / {ms['service'][1]:.1f} ms; "
        f"direct plan (engine=): the same dispatches, "
        f"{ms['direct'][0]:.1f} / {ms['direct'][1]:.1f} ms (in turns: "
        "service, direct, direct, service); host outputs bit-exact")

    # checkpoint-scale restore: every blob through the tiered store
    blobs = [(b, w) for ca, a in zip(cas, arrays)
             for b, w in zip(ca.blobs, expected_planes(a, len(ca.blobs)))]
    keys = [f"step_1/blob{i:03d}" for i in range(len(blobs))]
    window = STORE_WINDOW
    with tempfile.TemporaryDirectory() as root:
        backend = store.FilesystemBackend(root)
        writer = store.TieredBlobStore(backend)
        t0 = time.perf_counter()
        sizes = [writer.put(k, b) for k, (b, _) in zip(keys, blobs)]
        write_s = time.perf_counter() - t0
        writer.close()
        wins = [sum(sizes[i:i + window]) for i in range(0, len(keys), window)]
        pair = max(x + y for x, y in zip(wins, wins[1:] + [0]))
        low = 0.8
        # under the data even when a short run's data is small
        budget = max(min(STORE_BUDGET, sum(sizes) // 2),
                     int(pair / low) + 1)
        st = store.TieredBlobStore(backend, host_budget_bytes=budget,
                                   low_watermark=low)
        svc = server.DecompressionService(engine, cache_bytes=0, store=st)
        bad = []
        t0 = time.perf_counter()
        for i, objs in enumerate(st.stream_windows(keys, window=window,
                                                   release=False)):
            wkeys = keys[i * window:(i + 1) * window]
            futs = [svc.submit_key(k) for k in wkeys]
            for j, f in enumerate(futs):
                if not same(f.result(timeout=600),
                            blobs[i * window + j][1]):
                    bad.append(wkeys[j])
            del objs, futs
        restore_s = time.perf_counter() - t0
        s = st.stats()
        svc.close(timeout=60)
        st.close()
    if bad or s.backend_fetches != len(keys) or s.host_evictions < 1:
        raise AssertionError(f"store restore: {len(bad)} blobs differ, "
                             f"{s.backend_fetches} fetches for {len(keys)} "
                             f"keys, {s.host_evictions} evictions")
    log(f"   store: {len(keys)} blobs ({sum(sizes) / 2**20:.1f} MiB pickled, "
        f"written in {write_s:.2f} s) restored through "
        f"TieredBlobStore(host_budget_bytes={budget / 2**20:.1f} MiB; two "
        f"windows of {window} reach {pair / 2**20:.1f} MiB) + "
        f"stream_windows(window={window}) + submit_key: "
        f"{s.backend_fetches} fetches (each key once), {s.host_evictions} "
        f"evictions, host hit rate {s.host_hit_rate:.3f}, "
        f"{restore_s:.2f} s; all bit-exact")


def phase_ablation(args, data, engine, scalar, registry, harness,
                   transfers, errs, per) -> int:
    """The §V-E ablation on phase 4's staged plan: returns the single-thread
    kernel's launches in its counted run."""
    from repro_torch.roofline import analysis
    from repro_torch.core.engine import CodagEngine
    log("== 8 §V-E ablation: phase 4's staged plan through "
        "CodagEngine(EngineConfig(all_thread=False)).execute_device")
    plan = data["plan"]
    seng = CodagEngine(dataclasses.replace(engine.config, all_thread=False))
    n_groups = plan.num_dispatches
    scalar.LAUNCHES = 0
    for k in scalar.CODEC_LAUNCHES:
        scalar.CODEC_LAUNCHES[k] = 0
    t0 = time.perf_counter()
    outs_s = plan.execute_device(seng)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = scalar.LAUNCHES
    by_codec = dict(scalar.CODEC_LAUNCHES)
    if launches != n_groups:
        raise AssertionError(f"single-thread launches {launches}, expected "
                             f"{n_groups} (one per plan group)")
    outs_a = plan.execute_device(engine)
    torch.cuda.synchronize()
    wants = [w for a, ca in zip(data["arrays"], data["cas"])
             for w in expected_planes(a, len(ca.blobs))]
    for i, (o_s, o_a, want) in enumerate(zip(outs_s, outs_a, wants)):
        if not torch.equal(o_s.contiguous().reshape(-1).view(torch.uint8),
                           o_a.contiguous().reshape(-1).view(torch.uint8)):
            raise AssertionError(f"blob {i}: single-thread output differs "
                                 "from the all-thread output")
        if not same(o_s, want):
            raise AssertionError(f"blob {i}: single-thread output differs "
                                 "from the input")
    log(f"   {launches} single-thread launches == {n_groups} plan groups "
        f"{ {k: v for k, v in by_codec.items() if v} }; first call "
        f"{first_ms:.1f} ms; all {len(outs_s)} blobs bit-exact against the "
        "inputs and the all-thread output")
    del outs_s, outs_a
    torch.cuda.empty_cache()

    def run_staged(eng):
        with transfers.no_host_transfers():
            plan.execute_device(eng)

    reps = args.scalar_reps
    whole_s = ms_of(lambda: run_staged(seng), reps)
    whole_a = ms_of(lambda: run_staged(engine), reps)
    cap = {"tdeflate": args.td_plain_rows, "lzss": args.lz_plain_rows}
    tot = per["scalar_decode"]
    tot.update(all_thread_device_ms=0.0, plain_elems=args.scalar_plain_elems)
    for gi, g in enumerate(plan.groups):
        codec, width, chunk_elems, bits = g.key
        dev = plan._staged[engine.device][gi]
        spec = registry.get(codec).decode
        inputs = spec.chunk_inputs(dev)
        lens = dev["out_lens"]
        consts = harness.consts_on(spec, lens.device)
        kw = dict(chunk_elems=chunk_elems, width=width, bits=bits)
        s_ms = ms_of(lambda: spec.scalar(inputs, consts, lens, **kw), reps)
        s_dev = device_ms(lambda: spec.scalar(inputs, consts, lens, **kw),
                          reps)
        a_dev = device_ms(lambda: spec.cuda(inputs, consts, lens, **kw),
                          reps)
        # the plain scalar body on phase 4's plain-version rows, each row's
        # first --scalar-plain-elems elements (the same out_lens for both)
        rows = min(g.num_chunks, cap.get(codec, g.num_chunks))
        cut = tuple(t[:rows] for t in inputs)
        lens_cut = lens[:rows].clamp(max=args.scalar_plain_elems)
        out_k = spec.scalar(cut, consts, lens_cut, **kw)
        res = {}
        plain_ms = ms_of(lambda: res.update(
            p=spec.body_scalar(cut, consts, lens_cut, **kw)), 1)
        err = max_abs_err(out_k, res.pop("p"))
        del out_k
        errs["scalar_decode"] = max(errs["scalar_decode"], err)
        b = analysis.decode_bound_ms(codec, int(g.merged.comp_lens.sum()),
                                     g.num_chunks, chunk_elems, width)
        tot["ms"] += s_ms
        tot["device_ms"] += s_dev
        tot["all_thread_device_ms"] += a_dev
        tot["plain_ms"] += plain_ms
        tot["bound_ms"] += b
        tot["plain_rows"] += rows
        log(f"   group {g.key}: {g.num_chunks} chunks, "
            f"{scalar.block_threads(g.num_chunks, scalar._sms(lens.device))}"
            f" threads a CTA; single-thread {s_dev:.3f} ms device ({s_ms:.3f}"
            f" ms), all-thread {a_dev:.3f} ms device: {s_dev / a_dev:.1f}x; "
            f"bound {b:.3f} ms ({b / s_dev * 100:.2f}% of single-thread); 1 "
            f"launch; plain scalar body {plain_ms:.1f} ms on {rows} rows x "
            f"{args.scalar_plain_elems} elements, max_abs_err {err}")
        if err:
            raise AssertionError(f"group {g.key}: single-thread kernel "
                                 "differs from the plain scalar body")
    log(f"   total: single-thread {tot['device_ms']:.3f} ms device, "
        f"all-thread {tot['all_thread_device_ms']:.3f} ms device: "
        f"{tot['device_ms'] / tot['all_thread_device_ms']:.1f}x; staged "
        f"plan (execute_device, median of {reps}) {whole_s:.3f} ms "
        f"single-thread against {whole_a:.3f} ms all-thread: "
        f"{whole_s / whole_a:.1f}x")
    return launches


def phase_tuning(args, tuning, api, fmt, registry, engine) -> None:
    """autotune(smoke=True) on the card, in memory; then chunk_bytes=None on
    the card's kind."""
    log("== 9 tuning: tuning.autotune(smoke=True) on the card (an in-memory "
        "table, never saved)")
    t0 = time.perf_counter()
    table, rows = tuning.autotune(smoke=True, engine=engine, seed=args.seed)
    kind = tuning.device_kind()
    for name in registry.names():
        [(w, kinds)] = table["codecs"][name].items()
        [entry] = kinds.values()     # the one kind autotune ran on
        knobs = {k: v for k, v in entry.items() if not k.startswith("_")}
        log(f"   {name} {w}: tuned {entry['_tuned_MBps']:.3f} MB/s at "
            f"{knobs}, default {entry['_default_MBps']:.3f} MB/s "
            f"(chunk_bytes {fmt.DEFAULT_CHUNK_BYTES}, the launch's own "
            f"knobs); {entry['_size_mb']} MB of demo data")
    improved = dict((n, v) for n, v, _ in rows)["autotune/codecs_improved"]
    log(f"   {improved} of {len(registry.names())} codecs improved; kind "
        f"{kind!r}; {time.perf_counter() - t0:.1f} s")
    committed = tuning.load_table()
    if any(kind in kinds for ws in committed["codecs"].values()
           for kinds in ws.values()):
        raise AssertionError(f"the committed table has a {kind!r} row")
    rng = np.random.default_rng(args.seed)
    for name in registry.names():
        a = registry.get(name).demo_data(50_000, rng)
        ca = api.compress(a, name)
        blob = ca.blobs[0]
        if blob.chunk_elems * blob.width != fmt.DEFAULT_CHUNK_BYTES:
            raise AssertionError(f"{name}: chunk_bytes=None gave "
                                 f"{blob.chunk_elems} x {blob.width} bytes")
        if not same(api.decompress(ca, engine), a):
            raise AssertionError(f"{name}: chunk_bytes=None round trip")
    log(f"   no {kind!r} row in the committed table: api.compress(arr, "
        "codec) with chunk_bytes=None gives 128 KiB chunks for all seven "
        "codecs, and decodes back")


# --------------------------------------------------------------------------
# phase 10: the decode path's consumers
# --------------------------------------------------------------------------

QBLOCK = 128                       # src/repro/optim/adamw.py: int8 moments
                                   # with one f32 scale a block of 128
QWEN3_NORMS = ("attn_norm", "mlp_norm")   # a layer's two RMSNorm weights
VOCAB = 151936                     # qwen3's vocabulary
LOADER_BATCH, LOADER_SEQ = 8, 4096
LOW_WATERMARK = 0.8                # the store's default


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def int8_moment(gen, n: int, device, sqrt_domain: bool) -> dict:
    """An AdamW moment of ``n`` elements as the reference optimizer keeps
    it: int8 ``q`` of (n / 128, 128) and f32 ``s`` of (n / 128, 1); the
    second moment in the sqrt domain (non-negative)."""
    x = torch.randn(n // QBLOCK, QBLOCK, generator=gen, device=device)
    if sqrt_domain:
        x = x.abs()
    s = x.abs().amax(1, keepdim=True) / 127.0 + 1e-12
    return {"q": (x / s).round().clamp(-127, 127).to(torch.int8), "s": s}


def moment_state(gen, layers: int, device) -> dict:
    """The int8 AdamW state of ``layers`` qwen3-1.7B layers at full widths:
    m and v of the seven projections and two RMSNorm weights, and the
    step."""
    params = [(name, k * n) for name, k, n in QWEN3_PROJECTIONS]
    params += [(name, D_MODEL) for name in QWEN3_NORMS]
    state = {"step": torch.tensor(1000, dtype=torch.int32, device=device)}
    for which, sqrt_domain in (("m", False), ("v", True)):
        state[which] = {f"layer{i:02d}": {
            name: int8_moment(gen, n, device, sqrt_domain)
            for name, n in params} for i in range(layers)}
    return state


def same_tensor(got: torch.Tensor, want: torch.Tensor) -> bool:
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got, want.to(got.device)))


def restore_bound_ms(cas) -> float:
    """PERF.md §2's bytes bound of decoding every blob of ``cas``."""
    from repro_torch.roofline import analysis
    return sum(analysis.decode_bound_ms(b.codec, int(b.comp_lens.sum()),
                                        b.num_chunks, b.chunk_elems, b.width)
               for ca in cas for b in ca.blobs)


def store_budget(window_bytes: list, total: int) -> int:
    """A host budget below ``total`` that still fits one window under the
    low watermark, so each key is fetched once."""
    budget = max(total // 4, int(max(window_bytes) / LOW_WATERMARK) + 1)
    if budget >= total:
        raise AssertionError(f"a window of {max(window_bytes)} bytes does "
                             f"not fit a budget below the {total} bytes")
    return budget


def checkpoint_case(label, ckpt, store_mod, root: Path, state, codec: str,
                    window: int, engine, counters) -> dict:
    """Save ``state`` with ``codec``, then restore it three ways (host,
    ``device_out``, ``device_out`` streamed through a filesystem store
    under a budget below the checkpoint): each timed, each bit for bit equal
    to the saved state; launches by kernel."""
    device = engine.device
    sync(device)
    t0 = time.perf_counter()
    ckpt.save(str(root), 1, state, codec=codec)
    save_s = time.perf_counter() - t0
    manifest = json.loads((root / "step_1" / "manifest.json").read_text())
    keys = list(ckpt._flatten(state))
    files = [manifest["leaves"][k]["file"] + ".blob" for k in keys
             if manifest["leaves"][k]["codec"] != "none"]
    sizes = [(root / "step_1" / f).stat().st_size for f in files]
    cas = [ckpt._load_blob(root / "step_1" / f) for f in files]
    total = sum(sizes)
    budget = store_budget([sum(sizes[i:i + window])
                           for i in range(0, len(sizes), window)], total)
    want = ckpt._flatten(state)
    out_bytes = sum(t.numel() * t.element_size() for t in want.values())
    bound = restore_bound_ms(cas)
    comp = sum(ca.compressed_bytes for ca in cas) / max(1, sum(
        b.uncompressed_bytes for ca in cas for b in ca.blobs))
    log(f"   {label}: {len(keys)} leaves, {out_bytes / 2**20:.1f} MiB, "
        f"{len(files)} compressed with {codec} (ratio "
        f"{comp:.4f}; {total / 2**20:.1f} MiB of blob files); "
        f"save {save_s:.2f} s")
    res = {"save_s": save_s, "launches": {}}
    for way in ("host", "device_out", "store"):
        for c in counters.values():
            c.reset()
        stats = None
        sync(device)
        t0 = time.perf_counter()
        if way == "store":
            with store_mod.filesystem_store(
                    root, host_budget_bytes=budget) as st:
                out = ckpt.restore(str(root), 1, state, engine=engine,
                                   device_out=True, store=st,
                                   decode_window=window)
                sync(device)
                stats = st.stats()
        else:
            out = ckpt.restore(str(root), 1, state, engine=engine,
                               device_out=way == "device_out")
        sync(device)
        dt = time.perf_counter() - t0
        launched = {k: c.read() for k, c in counters.items() if c.read()}
        got = ckpt._flatten(out)
        home = torch.device("cpu") if way == "host" else device
        bad = [k for k in keys if got[k].device != home
               or not same_tensor(got[k], want[k])]
        if bad:
            raise AssertionError(f"{label} {way} restore: {bad[:5]} differ")
        if way == "host":
            res["host"] = got
        elif any(not same_tensor(got[k], res["host"][k]) for k in keys):
            raise AssertionError(f"{label} {way}: differs from the host "
                                 "restore")
        extra = ""
        if stats is not None:
            if stats.backend_fetches != len(files) or \
                    stats.host_evictions + stats.host_released < 1:
                raise AssertionError(
                    f"{label} store restore: {stats.backend_fetches} "
                    f"fetches for {len(files)} blobs, "
                    f"{stats.host_evictions} evictions")
            extra = (f"; store host_budget_bytes {budget / 2**20:.2f} MiB "
                     f"(< {total / 2**20:.2f} MiB), decode_window {window}: "
                     f"{stats.backend_fetches} fetches for {len(files)} keys "
                     f"(each once), {stats.host_evictions} evictions, "
                     f"{stats.host_released} released")
        log(f"   {label} restore {way}: {dt:.3f} s = "
            f"{out_bytes / dt / 1e9:.3f} GB/s decoded (the decode's bound "
            f"{bound:.3f} ms); launches {launched}; bit-exact{extra}")
        res[way + "_s"] = dt
        for k, v in launched.items():
            res["launches"][k] = res["launches"].get(k, 0) + v
        del out, got
    del res["host"]
    return res


def loader_epoch(label, loader, ref: torch.Tensor, n_batches: int, device,
                 counters) -> dict:
    """One epoch of ``loader``: every batch against the corpus, mismatches
    summed on the device and read once at the end; returns the launches by
    kernel."""
    for c in counters.values():
        c.reset()
    per = LOADER_BATCH * LOADER_SEQ
    bad = torch.zeros((), dtype=torch.int64, device=device)
    it = iter(loader)
    sync(device)
    t0 = time.perf_counter()
    for i in range(n_batches):
        b = next(it)
        lo = i * per
        for key, off in (("tokens", 0), ("labels", 1)):
            t = b[key]
            if t.device != device or t.dtype != torch.int32:
                raise AssertionError(f"loader {label}: {key} on {t.device}, "
                                     f"{t.dtype}")
            want = ref[lo + off:lo + off + per].view(LOADER_BATCH,
                                                     LOADER_SEQ)
            bad += (t != want).sum()
    sync(device)
    dt = time.perf_counter() - t0
    it.close()
    del it
    launched = {k: c.read() for k, c in counters.items() if c.read()}
    if int(bad):
        raise AssertionError(f"loader {label}: {int(bad)} tokens differ")
    deadline = time.time() + 5
    while time.time() < deadline:
        leaked = [t for t in threading.enumerate()
                  if t.name.startswith("codag-loader-prefetch")
                  and t.is_alive()]
        if not leaked:
            break
        time.sleep(0.05)
    if leaked:
        raise AssertionError(f"loader {label}: {leaked} outlive the iterator")
    log(f"   loader {label}: {n_batches} batches of {LOADER_BATCH} x "
        f"{LOADER_SEQ} in {dt:.3f} s = {n_batches * per / dt:.0f} tokens/s; "
        f"every batch equal to the corpus; launches {launched}; no "
        "codag-loader-prefetch thread after the iterator is dropped")
    return launched


def phase_consumers(args, engine, counters, server, store_mod,
                    keep: Path):
    """Phase 10: a compressed checkpoint of qwen3-1.7B train state restored
    three ways, the compressed token loader over one epoch in engine and
    service modes, and the fault-tolerant runner on the card.  The two
    checkpoints and the spilled corpus are left under ``keep`` (``moments``,
    ``weights``, ``shards``) for phase 14."""
    from repro_torch.roofline import analysis
    import gc
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.data import pipeline
    from repro_torch.distributed import fault
    log("== 10 consumers: compressed checkpoints, the token loader, the "
        "fault-tolerant runner")
    device = engine.device
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    launches: dict = {}

    def count(res):
        for k, v in res.items():
            launches[k] = launches.get(k, 0) + v

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        # (a) int8 AdamW moments through bitpack
        state = moment_state(gen, args.ckpt_layers, device)
        count(checkpoint_case(
            f"(a) bitpack, AdamW int8 moments of {args.ckpt_layers} "
            "qwen3-1.7B layers", ckpt, store_mod, keep / "moments", state,
            "bitpack", 8, engine, counters)["launches"])
        del state
        # (b) one layer's K and V projections, bf16, through tdeflate
        state = {name: torch.randn(k, n, generator=gen, device=device).to(
            torch.bfloat16) * 0.02 for name, k, n in QWEN3_PROJECTIONS
            if name in ("k", "v")}
        count(checkpoint_case(
            "(b) tdeflate, bf16 K and V weights of one layer", ckpt,
            store_mod, keep / "weights", state, "tdeflate", 1, engine,
            counters)["launches"])
        del state
        gc.collect()

        # the token loader over one epoch of a spilled rle_v2 corpus
        t0 = time.perf_counter()
        toks = pipeline.synthetic_corpus(args.corpus_tokens, VOCAB,
                                         seed=args.seed)
        corpus_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        store = pipeline.CompressedTokenStore.build(
            toks, VOCAB, spill_dir=str(keep / "shards"))
        build_s = time.perf_counter() - t0
        # half the payload bytes the store holds (nothing admitted yet)
        sizes = [p.stat().st_size
                 for p in sorted((keep / "shards").glob("shard_*.blob"))]
        budget = sum(sizes) // 2
        store.store.host_budget_bytes = budget
        # 64 KiB chunks of u32 tokens: PERF.md §2's bound of one epoch
        shard = 1 << 20
        chunks = sum(-(-min(shard, toks.size - i) // (16 << 10))
                     for i in range(0, toks.size, shard))
        bound = analysis.decode_bound_ms(
            "rle_v2", int(store.ratio * toks.nbytes), chunks, 16 << 10, 4)
        log(f"   corpus: {toks.size} tokens (vocab {VOCAB}, "
            f"{toks.nbytes / 2**20:.1f} MiB of u32, made in {corpus_s:.1f} s),"
            f" {store.num_shards} rle_v2 shards spilled to disk, ratio "
            f"{store.ratio:.4f} ({sum(sizes) / 2**20:.2f} MiB pickled, "
            f"encoded in {build_s:.1f} s), host budget "
            f"{budget / 2**20:.2f} MiB; the epoch's decode bound "
            f"{bound:.3f} ms ({chunks} chunks)")
        ref = torch.from_numpy(toks.astype(np.int32)).to(device) % VOCAB
        n_batches = (toks.size - 1) // (LOADER_BATCH * LOADER_SEQ)
        count(loader_epoch(
            "engine mode (decode_window=4, prefetch thread)",
            pipeline.CompressedLoader(store, LOADER_BATCH, LOADER_SEQ,
                                      engine=engine, decode_window=4,
                                      device_out=True),
            ref, n_batches, device, counters))
        with server.DecompressionService(engine, cache_bytes=0) as svc:
            count(loader_epoch(
                "service mode (4 shards in flight)",
                pipeline.CompressedLoader(store, LOADER_BATCH, LOADER_SEQ,
                                          service=svc, decode_window=4,
                                          device_out=True),
                ref, n_batches, device, counters))
        s = store.store.stats()
        log(f"   shard store after both epochs: {s.backend_fetches} fetches "
            f"for {store.num_shards} shards, {s.host_evictions} evictions, "
            f"host hit rate {s.host_hit_rate:.3f}")

        # the fault-tolerant runner, its state and steps on the card
        saved, restored = {}, []
        real_save, real_restore = ckpt.save, ckpt.restore
        rle = counters[kernel_of("rle_v2")]

        def spy_save(d, step, st, **kw):
            saved[step] = st["w"].clone()
            return real_save(d, step, st, **kw)

        def spy_restore(d, step, like, **kw):
            rle.reset()
            sync(device)
            t0 = time.perf_counter()
            out = real_restore(d, step, like, **kw)
            sync(device)
            restored.append((step, kw, out["w"], rle.read(),
                             time.perf_counter() - t0))
            return out

        def step_fn(st, batch):
            target = batch["tokens"].float() / VOCAB
            w = st["w"] - 0.2 * (st["w"] - target)
            return {"w": w}, float(((w - target) ** 2).mean())

        ckpt.save, ckpt.restore = spy_save, spy_restore
        try:
            runner = fault.FaultTolerantRunner(
                step_fn, str(tmp / "runner"), ckpt_every=5,
                injector=fault.FailureInjector(fail_at_steps=[7, 13]),
                async_ckpt=True, ckpt_codec="rle_v2", engine=engine)
            loader = pipeline.CompressedLoader(
                store, LOADER_BATCH, LOADER_SEQ, engine=engine,
                prefetch=False, device_out=True)
            t0 = time.perf_counter()
            w0 = torch.zeros(LOADER_BATCH, LOADER_SEQ, device=device)
            out, report = runner.run({"w": w0}, loader, 20)
            sync(device)
            run_s = time.perf_counter() - t0
        finally:
            ckpt.save, ckpt.restore = real_save, real_restore
        store.store.close()
    if (report.restarts, report.steps_done) != (2, 20) or \
            out["w"].device != device:
        raise AssertionError(f"runner: {report}")
    for step, kw, w, n, _ in restored:
        if not kw.get("device_out") or w.device != device or n < 1 or \
                not same_tensor(w, saved[step]):
            raise AssertionError(f"runner restore of step {step}: "
                                 f"device_out={kw.get('device_out')}, on "
                                 f"{w.device}, {n} launches, or it differs")
    count({kernel_of("rle_v2"): sum(r[3] for r in restored)})
    log(f"   runner: {report.steps_done} steps, {report.restarts} restarts "
        f"(failures injected at steps 7 and 13), rle_v2 checkpoints every 5 "
        f"steps (async), {run_s:.2f} s; restores of steps "
        f"{[r[0] for r in restored]} on {device}, "
        f"{[r[3] for r in restored]} two_phase_rle<rle_v2> launches, "
        f"{', '.join(f'{r[4] * 1e3:.1f}' for r in restored)} ms, each equal "
        "to the state saved at its step; final loss "
        f"{report.losses[-1]:.6f}")
    for name in ("bitpack_unpack", "tdeflate_decode", kernel_of("rle_v2")):
        if launches.get(name, 0) < 1:
            raise AssertionError(f"phase 10 launched no {name}")
    log(f"   phase 10 launches: {launches}")
    return launches


# --------------------------------------------------------------------------
# phases 11 and 12: the model stack on the card
# --------------------------------------------------------------------------

# decode-step logits against forward's, bf16 on the card: 8 bf16 ulps at
# the logits' scale (|logit| in [4, 8): an ulp is 2^-5); the two paths
# round their matmuls (M = 8 rows against M = 768) and softmaxes apart.
# An MoE is held to it on a replay that takes forward's routes.
SERVE_TOL = 0.25
# The random-weight recurrent stacks carry a rounding through every layer
# and do not damp it: the reference's own bf16 forward lies 1.9 (rwkv6, 24
# layers) and 4.6 (zamba2, 54 layers) from its float32 forward on the same
# weights, on logits of ~4.5, and its own float32 decode 1.9e-4 and 4.7e-2
# from its float32 forward (``python tests/test_torch_precision.py
# --decode``, CPU, width 256).  On this card at full width the served bf16
# forward lies 1.76 (rwkv6) and 7.03 (zamba2) from a float32 forward of
# the same weights, and bf16 decode 0.74 and 5.45 from bf16 forward
# (H100 80GB HBM3, 700 W; PERF.md §5).  So their bf16 limits are twice
# those decode readings, and what holds their decode to forward is the
# float32 replay below.
SERVE_TOL_RECURRENT = {"rwkv6": 1.5, "mamba2": 11.0}
# float32 on the served weights at full depth, TF32 off: decode against
# forward, and forward of row 0 alone against the batch.  Readings (same
# card): rwkv6 2.1e-4 and 2.5e-4; zamba2 0.66 and 0.027.  The limits are
# ~2-5x the readings; a zamba2 decode whose shared block read another
# application's K/V lies beyond 1.5 at every position after the first
# (``tests/test_torch_cuda.py::
# test_hybrid_float32_decode_at_full_depth_tells_a_shared_kv_apart``).
SERVE_F32_TOL = {"rwkv6": 1e-3, "mamba2": 1.5}
TRAIN_LAYERS = 4                   # the training run's depth cut (of 28)
# The reference's int8 moments keep v in the sqrt domain: where an
# element's v quantizes to 0 and its m does not (and the int8 wire rounds
# its gradient to 0), the update is lr * m / eps.  At 3e-5 and above the
# 12-step run diverges; at this rate its loss falls.
TRAIN_LR = 1e-5
MODEL_TOL = 1e-3                   # card against CPU, float32, no TF32

# the plain wire decode (the bitpack body, then Epilogue.apply) runs in
# slices of this many rows of 128: its int64 transients stay ~1 GB on an
# 805 M-element MoE expert leaf
WIRE_CHECK_ROWS = 1 << 20


class RouteTape:
    """Stands in for ``models.moe.top_k`` (``_dispatch_group`` looks it up
    at each call) and records, a call, the router logits it was given and
    the experts the program's own ``top_k`` chose: a forward makes one call
    a layer (a dispatch group), a decode step one a layer a step.  With
    ``force`` (routes in call order, each like that call's ``ids``), call
    i takes ``force[i]``, its gates from its own logits at those
    experts."""

    def __init__(self, force=None):
        self.force = force
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.real = moe, moe.top_k
        moe.top_k = self
        return self

    def __exit__(self, *exc):
        self.moe.top_k = self.real

    def __call__(self, logits, k):
        vals, ids = self.real(logits, k)
        i = len(self.calls)
        self.calls.append((logits.detach().float(), ids))
        if self.force is not None:
            ids = self.force[i].to(ids.device)
            return torch.gather(logits, -1, ids), ids
        return vals, ids


def near_tie_flips(ref_lg, ref_ids, own_lg, own_ids) -> dict:
    """Routes chosen on router logits ``own_lg`` (..., E) against those
    chosen on ``ref_lg`` (``own_ids`` / ``ref_ids``, (..., K)), both taken
    on the same routes so the logits differ by rounding alone, ``eps`` a
    token: two top-k selections of logits within ``eps`` of each other can
    differ only where the reference's k-th and (k+1)-th logits lie within
    2 * ``eps``, so a flip beyond that (or where the logits are equal) is a
    fault.  Returns flips, routes (tokens), faults, the largest ``eps``
    and ``eps`` itself."""
    K = ref_ids.shape[-1]
    eps = (own_lg - ref_lg).abs().amax(-1)
    flipped = (torch.sort(own_ids, -1).values
               != torch.sort(ref_ids, -1).values).any(-1)
    top = ref_lg.topk(K + 1, dim=-1).values
    gap = top[..., K - 1] - top[..., K]
    return {"flips": int(flipped.sum()), "routes": flipped.numel(),
            "faults": int((flipped & ((gap > 2 * eps) | (eps == 0))).sum()),
            "eps": float(eps.max()), "eps_by_token": eps}


def replay_decode(cfg, params, seq, device, force=None):
    """``decode_step`` over every position of ``seq`` on a fresh cache:
    (logits (B, S, V), the tape's calls).  ``force``: forward's routes by
    layer, (B, S, K) each, imposed on every step."""
    from repro_torch.models import model
    B, S = seq.shape
    cache = model.init_cache(cfg, B, S + 8, device=device)
    dec = []
    if force is not None:             # in call order: a step, its layers
        force = [force[layer][:, i] for i in range(S)
                 for layer in range(cfg.n_layers)]
    with RouteTape(force) as tape:
        for i in range(S):
            lg, cache = model.decode_step(cfg, params, cache, seq[:, i:i + 1])
            dec.append(lg)
    return torch.cat(dec, dim=1), tape.calls


def f32_replay(cfg, params, seq, full_bf16, device) -> dict:
    """The served weights in float32 at the served depth, TF32 off:
    ``forward``, ``forward`` of row 0 alone and ``decode_step`` replayed
    over every position of ``seq``.  Returns the largest |decode -
    forward|, |row 0 alone - batched| and |bf16 forward - float32
    forward| (the served model's own bf16 rounding)."""
    from repro_torch.core.tree import map_tree
    from repro_torch.models import model
    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = map_tree(lambda t: t.float() if t.is_floating_point() else t,
                   params)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        full = model.forward(c32, p32, seq)
        alone = model.forward(c32, p32, seq[:1])
        dec, _ = replay_decode(c32, p32, seq, device)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    pos = (dec - full).abs().amax(dim=(0, 2))
    res = {"decode": float(pos.max()),
           "by_pos": [float(pos[a:b].max()) for a, b in
                      ((0, 1), (1, 8), (8, 32), (32, seq.shape[1]))],
           "alone": float((alone - full[:1]).abs().max()),
           "bf16": float((full_bf16.float() - full).abs().max()),
           "finite": bool(torch.isfinite(full).all()
                          and torch.isfinite(dec).all())}
    del p32, full, alone, dec
    return res


def moe_routes(cfg, params, seq, fwd_calls, device, first_step: int):
    """An MoE's decode replayed on forward's routes (``RouteTape``), its
    logits returned with what its routes say: the (layer, token)s where
    decode's own ``top_k`` chose otherwise, and those of them that are no
    near tie (``near_tie_flips``).  ``distinct``: the experts decode's own routes reach, a layer a
    step, over the steps from ``first_step`` (the served decode steps)."""
    B, S = seq.shape
    L, K = cfg.n_layers, cfg.top_k
    fwd_lg = torch.stack([lg.view(B, S, -1) for lg, _ in fwd_calls])
    fwd_ids = torch.stack([ids.view(B, S, K) for _, ids in fwd_calls])
    dec, calls = replay_decode(cfg, params, seq, device, force=fwd_ids)

    def by_layer(j):                  # (L, B, S, ...) from the replay
        return torch.stack([torch.stack(
            [calls[i * L + layer][j] for i in range(S)], dim=1)
            for layer in range(L)])

    own = by_layer(1)
    r = near_tie_flips(fwd_lg, fwd_ids, by_layer(0), own)
    distinct = [[own[layer, :, i].unique().numel() for i in
                 range(first_step, S)] for layer in range(L)]
    return dec, {"flips": r["flips"], "routes": r["routes"],
                 "faults": r["faults"], "eps": r["eps"], "distinct": distinct}


def serve_and_check(label: str, sargs, device, check_cfg=None) -> dict:
    """``launch.serve.run_serving(sargs)`` timed beside its decode-step
    bound (``analysis.decode_step_bytes``); then ``decode_step`` replayed
    over every position on a fresh cache against ``forward``'s logits within
    a fixed limit, and the greedy tokens against ``forward``'s argmax wherever its
    top-2 margin exceeds twice the limit (so the two cannot disagree by
    rounding alone).  ``check_cfg``: the config of the replay and
    ``forward`` (an MoE's no-drop capacity), else the served one.

    The limit is ``SERVE_TOL``; a recurrent family's bf16 limit is
    ``SERVE_TOL_RECURRENT``, and its decode is held to ``forward`` (and
    ``forward`` of row 0 alone to the batched one) within
    ``SERVE_F32_TOL`` on the served weights in float32 at the same depth
    (``f32_replay``).  An MoE's router sees the two paths' bf16 roundings
    of the same hidden state, so a token whose k-th and (k+1)-th logits
    nearly tie may take another expert in one path and carry the change
    to later layers and positions: its replay takes forward's routes
    (``moe_routes``), and each route decode's own top-k would change must
    be a near tie by the rounding on those same routes.  Returns the run's
    numbers."""
    from repro_torch.roofline import analysis
    import gc
    from repro_torch.core.tree import leaves as tree_leaves
    from repro_torch.launch import serve
    from repro_torch.models import model
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = serve.run_serving(sargs)
    serve_s = time.perf_counter() - t0
    cfg, params = out["cfg"], out["params"]
    B, P, G = sargs.batch, sargs.prompt_len, sargs.gen
    n_params = sum(t.numel() for t in tree_leaves(params))
    step_ms = out["decode_s"] / G * 1e3
    step_bytes, w_bytes, kv_bytes, st_bytes = analysis.decode_step_bytes(
        cfg, params, out["cache"], B)
    bound = step_bytes / analysis.HBM_BW * 1e3
    log(f"   {label} serve: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.mixer} mixer, vocab {cfg.vocab}: {n_params / 1e9:.3f} B "
        f"parameters in {cfg.dtype}; run_serving {serve_s:.2f} s (init "
        f"included)")
    log(f"   prefill (per-token loop) {B}x{P} in {out['prefill_s']:.3f} s; "
        f"decode {B}x{G} in {out['decode_s']:.3f} s = "
        f"{B * G / out['decode_s']:.1f} tok/s, {step_ms:.3f} ms a decode "
        f"step; bound {step_bytes / 1e9:.3f} GB a step (weights "
        f"{w_bytes / 1e9:.3f}, attention caches {kv_bytes / 1e9:.3f}, "
        f"recurrent states read and written {st_bytes / 1e9:.3f}) = "
        f"{bound:.3f} ms; the step {step_ms / bound:.1f}x its bound")
    ccfg = check_cfg or cfg
    t0 = time.perf_counter()
    seq = torch.cat([out["prompts"].to(device),
                     torch.from_numpy(out["tokens"]).to(device)], dim=1)
    S = P + G
    tol = SERVE_TOL_RECURRENT.get(ccfg.mixer, SERVE_TOL)
    notes, problems, f32 = "", [], None
    with torch.no_grad():
        with RouteTape() as fwd_tape:
            full = model.forward(ccfg, params, seq)
        if ccfg.is_moe:
            dec, r = moe_routes(ccfg, params, seq, fwd_tape.calls, device, P)
            moe = params["blocks"]["moe"]
            per_expert = sum(moe[k][0, 0].numel() * moe[k].element_size()
                             for k in ("w_up", "w_gate", "w_down"))
            unread = np.mean([sum(ccfg.n_experts - d[i] for d in
                                  r["distinct"]) for i in range(G)])
            routed = (step_bytes - unread * per_expert) \
                / analysis.HBM_BW * 1e3
            share = r["flips"] / r["routes"]
            notes = (f"; on forward's routes: decode's own top-k differs "
                     f"at {r['flips']} of {r['routes']} (layer, token)s "
                     f"({share:.2%}), {r['faults']} of them beyond twice "
                     f"the two paths' router-logit difference there "
                     f"(largest {r['eps']:.4f})")
            if r["faults"]:
                problems.append(f"{r['faults']} routes differ from "
                                f"forward's beyond the router logits' "
                                f"rounding")
            log(f"   routed bound: {np.mean(r['distinct']):.1f} distinct "
                f"experts of {ccfg.n_experts} a layer a step (the replay's "
                f"own routes at the {G} served steps; {B} tokens x top "
                f"{ccfg.top_k}), {unread * per_expert / 1e9:.3f} GB of "
                f"experts unread = {routed:.3f} ms; the step "
                f"{step_ms / routed:.1f}x it (the dense bound above is "
                f"this implementation's: every expert computes its slots)")
        else:
            dec, _ = replay_decode(ccfg, params, seq, device)
        if ccfg.sub_quadratic:
            f32 = f32_replay(ccfg, params, seq, full, device)
            f32_tol = SERVE_F32_TOL[ccfg.mixer]
            if not f32["finite"] or f32["decode"] > f32_tol or \
                    f32["alone"] > f32_tol:
                problems.append(f"float32: {f32}")
        diff = (dec.float() - full.float()).abs()
        top2 = full[:, P - 1:P + G - 1].float().topk(2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        greedy = torch.from_numpy(out["tokens"]).to(device)
        arg = full[:, P - 1:P + G - 1].argmax(-1)
        sure = margin > 2 * tol
        wrong = int(((arg != greedy) & sure).sum())
        max_d, mean_d = float(diff.max()), float(diff.mean())
        max_logit = float(full.float().abs().max())
        finite = bool(torch.isfinite(full).all() and torch.isfinite(dec).all())
    check_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    if not finite or max_d > tol or wrong:
        problems.append(f"finite={finite}, max |decode - forward| {max_d} "
                        f"(limit {tol}), {wrong} greedy tokens differ from "
                        f"forward's argmax")
    if problems:
        raise AssertionError(f"{label} serve: " + "; ".join(problems)
                             + notes)
    log(f"   decode_step logits == forward's at all {S} positions of "
        f"{B} rows within {tol:g} ({cfg.dtype}; max |diff| {max_d:.4f}, "
        f"mean {mean_d:.5f}, max |logit| {max_logit:.3f}); greedy tokens "
        f"== forward's argmax at all {int(sure.sum())} of {B * G} "
        f"positions whose top-2 margin exceeds {2 * tol:g} "
        f"({int((arg == greedy).sum())} of {B * G} equal in all){notes}; "
        f"check {check_s:.2f} s; peak memory {peak / 2**30:.2f} GiB")
    if f32:
        log(f"   float32 at {ccfg.n_layers} layers, the served weights, "
            f"TF32 off: decode_step == forward within {f32_tol:g} "
            f"(max |diff| {f32['decode']:.3e}; by position 0, 1-7, 8-31, "
            f"32-: {', '.join(f'{x:.2e}' for x in f32['by_pos'])}), row 0's "
            f"forward alone == "
            f"batched within it ({f32['alone']:.3e}); the served bf16 "
            f"forward lies {f32['bf16']:.4f} from this float32 forward "
            f"(bf16 rounding alone)")
    res = {"serve_s": serve_s, "prefill_s": out["prefill_s"],
           "tok_s": B * G / out["decode_s"], "step_ms": step_ms,
           "bound_ms": bound, "max_diff": max_d, "peak_gib": peak / 2**30,
           "params_b": n_params / 1e9}
    del out, params, full, dec, diff, seq
    gc.collect()
    torch.cuda.empty_cache()
    return res


def check_wire(dev: dict, kw: dict, res: torch.Tensor) -> bool:
    """A wire decode (the fused ``bitpack_unpack``) against the plain bitpack
    body followed by ``Epilogue.apply``, bit for bit, in slices of
    ``WIRE_CHECK_ROWS`` rows."""
    from repro_torch.kernels import bitpack
    words = dev["comp_words"]
    n = words.shape[0]
    if res.dtype != torch.float32 or tuple(res.shape) != \
            (n, kw["chunk_elems"]):
        return False
    for s in range(0, n, WIRE_CHECK_ROWS):
        e = min(s + WIRE_CHECK_ROWS, n)
        part = {k: v[s:e] if v.dim() and v.shape[0] == n else v
                for k, v in dev.items()}
        plain = kw["epilogue"].apply(bitpack.unpack(
            part["comp_words"], chunk_elems=kw["chunk_elems"], width=1,
            bits=kw["bits"]), part)
        if plain.dtype != res.dtype or not torch.equal(res[s:e], plain):
            return False
    return True


def checked_training(targs, counters, device, drawn=None) -> tuple:
    """``launch.train.run_training(targs)`` with its kernels held: every
    rle_v2 decode of the loader against the plain rle_v2 body on its
    inputs (after the run, so the check takes no time from the steps), every
    batch against the corpus the driver built, the first step's wire
    decodes (one a gradient leaf) against the plain bitpack body +
    ``Epilogue.apply`` (``check_wire``), and each wire decode's launches.
    Returns (the run's dict, what was checked and launched, the restores),
    the peak memory of the run in the dict.  ``drawn``: a list that gets a
    copy of every batch the run drew."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import plan as plan_mod, registry
    from repro_torch.core.tree import leaves as tree_leaves
    from repro_torch.data import pipeline
    from repro_torch.kernels import harness
    from repro_torch.launch import train
    wire = {"launches": [], "checked": 0, "err": 0}
    shards = {"seen": [], "checked": 0, "err": 0}
    fed = {"corpus": None, "batches": 0, "bad": None}
    restored = []
    real_dispatch, real_restore = plan_mod.dispatch, ckpt.restore
    real_corpus, real_loader = pipeline.synthetic_corpus, train._build_loader
    bp = counters["bitpack_unpack"]
    rle = counters[kernel_of("rle_v2")]
    rle_spec = registry.get("rle_v2").decode

    def spy_corpus(*a, **kw):
        fed["corpus"] = real_corpus(*a, **kw)
        return fed["corpus"]

    def checked_batches(loader, vocab, batch, seq):
        per = batch * seq
        ref = torch.from_numpy(fed["corpus"].astype(np.int32)).to(device)
        ref %= vocab
        fed["bad"] = torch.zeros((), dtype=torch.int64, device=device)
        for i, b in enumerate(loader):
            lo = i * per
            if lo + per + 1 > ref.numel():
                raise AssertionError(f"train: batch {i} runs past the corpus")
            for key, off in (("tokens", 0), ("labels", 1)):
                t = b[key]
                if t.device != device or t.dtype != torch.int32:
                    raise AssertionError(f"train: {key} on {t.device}, "
                                         f"{t.dtype}")
                fed["bad"] += (t != ref[lo + off:lo + off + per].view(
                    batch, seq)).sum()
            fed["batches"] += 1
            if drawn is not None:
                drawn.append({k: v.clone() for k, v in b.items()})
            yield b

    def spy_loader(a, cfg, dev):
        return checked_batches(real_loader(a, cfg, dev), cfg.vocab, a.batch,
                               a.seq)

    def spy_dispatch(dev, **kw):
        before = bp.read()
        res = real_dispatch(dev, **kw)
        if kw.get("codec") == "rle_v2":
            shards["seen"].append((dev, kw, res.clone()))
        if kw.get("codec") == "bitpack" and "wire_scale" in dev:
            wire["launches"].append(bp.read() - before)
            if fed["batches"] == 1:        # the first step's decodes
                wire["err"] += not check_wire(dev, kw, res)
                wire["checked"] += 1
        return res

    def spy_restore(d, step, like, **kw):
        res = real_restore(d, step, like, **kw)
        restored.append((step, kw.get("device_out"),
                         {t.device for t in tree_leaves(res[0])}))
        return res

    tcfg = train._resolve_cfg(targs)
    torch.cuda.reset_peak_memory_stats(device)
    plan_mod.dispatch, ckpt.restore = spy_dispatch, spy_restore
    pipeline.synthetic_corpus, train._build_loader = spy_corpus, spy_loader
    try:
        bp.reset()
        rle.reset()
        t0 = time.perf_counter()
        m = train.run_training(targs)
        m["run_s"] = time.perf_counter() - t0
        m["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    finally:
        plan_mod.dispatch, ckpt.restore = real_dispatch, real_restore
        pipeline.synthetic_corpus = real_corpus
        train._build_loader = real_loader
    for dev, kw, res in shards.pop("seen"):
        lens = dev["out_lens"]
        plain = rle_spec.body(
            rle_spec.chunk_inputs(dev),
            harness.consts_on(rle_spec, lens.device), lens,
            chunk_elems=kw["chunk_elems"], width=kw["width"],
            bits=kw.get("bits", 0))
        if kw.get("epilogue") is not None:
            plain = kw["epilogue"].apply(plain, dev)
        if res.dtype != plain.dtype or res.numel() != plain.numel() or \
                not torch.equal(bit_view(res).reshape(-1),
                                bit_view(plain).reshape(-1)):
            shards["err"] += 1
        shards["checked"] += 1
    launches = {"bitpack_unpack": bp.read(), kernel_of("rle_v2"): rle.read()}
    return m, {"wire": wire, "shards": shards, "fed": fed,
               "launches": launches, "cfg": tcfg}, restored


def training_problems(m, rec, n_wire: int, unfused: int) -> list:
    """What failed of ``checked_training``'s checks, for a run of
    ``n_wire`` wire leaves: one fused wire launch a leaf a step, the first
    step's decodes equal to the plain version, every loader decode checked
    and equal, every batch drawn equal to the corpus, and the loss fallen
    (the mean of the last tenth of the steps below that of the first)."""
    from repro_torch.kernels import harness
    wire, shards, fed = rec["wire"], rec["shards"], rec["fed"]
    launches = rec["launches"]
    steps_run = len(m["losses"])
    losses = m["losses"]
    k = max(1, len(losses) // 10)
    problems = []
    if not float(np.mean(losses[-k:])) < float(np.mean(losses[:k])):
        problems.append(f"loss did not fall: {losses}")
    if wire["launches"] != [1] * (n_wire * steps_run) or \
            launches["bitpack_unpack"] != n_wire * steps_run:
        problems.append(f"wire launches {launches['bitpack_unpack']} for "
                        f"{n_wire} leaves x {steps_run} steps")
    if harness.EPILOGUE_UNFUSED != unfused:
        problems.append("an unfused wire epilogue")
    if wire["err"] or wire["checked"] != n_wire:
        problems.append(f"{wire['err']} of {wire['checked']} wire decodes "
                        "differ from the plain body + Epilogue.apply")
    if launches[kernel_of("rle_v2")] < 1:
        problems.append("the loader launched no rle_v2 decode")
    if shards["err"] or shards["checked"] != launches[kernel_of("rle_v2")]:
        problems.append(f"{shards['err']} of {shards['checked']} rle_v2 "
                        "decodes differ from the plain body, or not every "
                        "launch was checked")
    drawn = steps_run + m["restarts"]     # a failed step drew its batch
    if fed["batches"] != drawn or fed["bad"] is None or int(fed["bad"]):
        problems.append(f"{fed['batches']} batches for {drawn} draws, "
                        f"{None if fed['bad'] is None else int(fed['bad'])} "
                        "tokens differ from the corpus")
    return problems


def log_training(label: str, m, rec, targs, params) -> None:
    """Log a ``checked_training`` run: losses, peak memory, the median step
    beside ``analysis.train_step_bound``, launches and what was held."""
    from repro_torch.roofline import analysis
    from repro_torch.core.tree import leaves
    tcfg = rec["cfg"]
    losses = m["losses"]
    k = max(1, len(losses) // 10)
    tokens = targs.batch * targs.seq
    step_s = float(np.median(m["step_seconds"]))
    bound, by, flops, nbytes = analysis.train_step_bound(
        tcfg, params, targs.batch, targs.seq)
    n = sum(t.numel() for t in leaves(params))
    log(f"   {label} train: {tcfg.n_layers} layers at full width "
        f"({n / 1e6:.1f} M parameters), batch {targs.batch} x seq "
        f"{targs.seq}, --grad-int8 --compress-moments, lr {targs.lr}, "
        f"{targs.steps} steps in {m['run_s']:.2f} s (loader, init and "
        f"checkpoints included); losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}: first "
        f"{np.mean(losses[:k]):.4f} -> last {np.mean(losses[-k:]):.4f}; "
        f"peak memory {m['peak_gib']:.2f} GiB")
    log(f"   step {step_s * 1e3:.2f} ms (median of {len(m['step_seconds'])}"
        f", host clock, synchronised) = {tokens / step_s:.0f} tokens/s; "
        f"bound {bound:.2f} ms by {by}: {flops / 1e12:.2f} TFLOP at "
        f"{analysis.PEAK_FLOPS / 1e12:.0f} TFLOP/s = "
        f"{flops / analysis.PEAK_FLOPS * 1e3:.2f} "
        f"ms, {nbytes / 1e9:.2f} GB = {nbytes / analysis.HBM_BW * 1e3:.2f} "
        f"ms (train_step_bound); the step {step_s * 1e3 / bound:.1f}x its "
        f"bound")
    wire, shards, fed = rec["wire"], rec["shards"], rec["fed"]
    log(f"   launches {rec['launches']}: one fused bitpack_unpack a wire "
        f"leaf a step; the first step's {wire['checked']} wire decodes == "
        f"plain bitpack body + Epilogue.apply bit for bit (slices of "
        f"{WIRE_CHECK_ROWS} rows); the loader's {shards['checked']} rle_v2 "
        f"decodes == the plain rle_v2 body bit for bit, its "
        f"{fed['batches']} batches == the corpus")


def card_vs_cpu(label: str, ccfg, seed: int, device,
                decode: bool = False) -> float:
    """``forward`` and ``loss_fn`` of ``ccfg`` (float32) on the card against
    the same on the CPU on the same weights, TF32 off, within
    ``MODEL_TOL``; with ``decode``, also ``decode_step`` replayed on the
    card over the 32 positions against the card's ``forward`` within it.
    Returns the seconds it took."""
    import gc
    from repro_torch.core.tree import map_tree
    from repro_torch.models import model
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        cpu = model.init_params(ccfg, torch.Generator().manual_seed(seed),
                                device="cpu")
        gpu = map_tree(lambda t: t.to(device), cpu)
        rng = np.random.default_rng(seed)
        tok = torch.from_numpy(rng.integers(0, ccfg.vocab, (2, 32)).astype(
            np.int32))
        lab = torch.from_numpy(rng.integers(0, ccfg.vocab, (2, 32)).astype(
            np.int32))
        with torch.no_grad():
            want = model.forward(ccfg, cpu, tok)
            got = model.forward(ccfg, gpu, tok.to(device)).cpu()
            lw = model.loss_fn(ccfg, cpu, tok, lab)
            lg = model.loss_fn(ccfg, gpu, tok.to(device),
                               lab.to(device)).cpu()
            dec_err = 0.0
            if decode:
                dec, _ = replay_decode(ccfg, gpu, tok.to(device), device)
                dec_err = float((dec.cpu() - got).abs().max())
        took = time.perf_counter() - t0
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    err = float((got - want).abs().max())
    ok = torch.allclose(got, want, rtol=MODEL_TOL, atol=MODEL_TOL) and \
        torch.allclose(lg, lw, rtol=MODEL_TOL, atol=MODEL_TOL) and \
        dec_err <= MODEL_TOL
    if not ok:
        raise AssertionError(f"{label} card != CPU: max |logit diff| {err}, "
                             f"loss {float(lg)} against {float(lw)}, decode "
                             f"against forward {dec_err}")
    decoded = (f"; decode_step on the card == its forward within "
               f"{MODEL_TOL} (max |diff| {dec_err:.2e})" if decode else "")
    log(f"   {label}: {ccfg.n_layers} layers at full width, float32, TF32 "
        f"off: forward on {device} == on the CPU within rtol=atol="
        f"{MODEL_TOL} (max |diff| {err:.2e} over {got.numel()} logits), "
        f"loss_fn {float(lg):.6f} against {float(lw):.6f}{decoded}; "
        f"{took:.1f} s")
    del cpu, gpu
    gc.collect()
    torch.cuda.empty_cache()
    return took


def wire_step_ms(args, engine, leaves) -> None:
    """One step's wire decode, device time, against its bytes: the given
    leaves stand in for gradients of the same shapes."""
    from repro_torch.roofline import analysis
    from repro_torch.core import plan as plan_mod
    from repro_torch.distributed import collectives
    from repro_torch.kernels import bitpack, harness
    from repro_torch.optim import grad_compress as gc_mod
    device = engine.device
    tables = []
    for t in leaves:
        if t.numel() >= gc_mod.QBLOCK:
            dev, s = collectives.quantized_wire(t)
            dev["wire_scale"] = s
            dev["wire_zero"] = torch.full((), collectives.WIRE_ZERO,
                                          device=device)
            tables.append(dev)
    epi = harness.Epilogue(out_dtype="float32", scale_key="wire_scale",
                           zero_key="wire_zero")
    cfg_e = engine.config

    def decode_all():
        for dev in tables:
            plan_mod.dispatch(dev, config=cfg_e, codec="bitpack", width=1,
                              chunk_elems=gc_mod.QBLOCK, bits=8,
                              epilogue=epi)

    decode_all()
    # ~20 ms of device sleep: the launches' host time stays behind it
    wire_ms = device_ms(decode_all, args.reps, sleep_cycles=40_000_000)
    rows = sum(d["comp_words"].shape[0] for d in tables)
    wire_bytes = rows * (4 * 32 + 4 + 4 * gc_mod.QBLOCK)
    big = max(tables, key=lambda d: d["comp_words"].shape[0])
    plain_ms = ms_of(lambda: epi.apply(bitpack.unpack(
        big["comp_words"], chunk_elems=gc_mod.QBLOCK, width=1, bits=8), big),
        1)
    log(f"   wire decode a step: {len(tables)} bitpack_unpack launches over "
        f"{rows} rows of {gc_mod.QBLOCK}, device {wire_ms:.3f} ms (median "
        f"of {args.reps}); bound {wire_bytes / 1e9:.3f} GB (words read, "
        f"scales, float32 written) = "
        f"{wire_bytes / analysis.HBM_BW * 1e3:.3f} ms; the plain body + "
        f"apply on the largest leaf ({big['comp_words'].shape[0]} rows) "
        f"{plain_ms:.3f} ms")


def phase_model(args, engine, counters):
    """Phase 11: qwen3-1.7B served at full width and depth, a 4-layer
    full-width training run through the loader, the int8 gradient wire and
    the fault-tolerant runner, and the model on the card against the CPU.
    Returns the launches by kernel."""
    import gc
    from repro_torch.configs import get_arch
    from repro_torch.core.tree import leaves as tree_leaves
    from repro_torch.kernels import harness
    from repro_torch.launch import serve, train
    from repro_torch.optim import grad_compress as gc_mod
    log("== 11 the model stack: qwen3-1.7B (hf:Qwen/Qwen3-1.7B) served at "
        "full width and depth, trained at 4 layers through the int8 "
        "gradient wire, card against CPU")
    device = engine.device
    for c in counters.values():
        c.reset()

    # (a) serve: 28 layers, bf16, 8 prompts of 64 tokens, 32 greedy tokens
    serve_and_check("(a) qwen3-1.7B", serve.build_parser().parse_args(
        ["--arch", "qwen3-1.7b", "--preset", "full", "--batch", "8",
         "--prompt-len", "64", "--gen", "32", "--device", str(device)]),
        device)

    # (b) train: 4 layers at full width, batch 8 x seq 512, int8 wire and
    # moments, 12 steps, checkpoints every 5, a failure at step 7
    (ROOT / "build").mkdir(exist_ok=True)
    unfused = harness.EPILOGUE_UNFUSED
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        targs = train.build_parser().parse_args(
            ["--arch", "qwen3-1.7b", "--preset", "full", "--n-layers",
             str(TRAIN_LAYERS), "--batch", "8", "--seq", "512", "--steps",
             "12", "--lr", str(TRAIN_LR), "--grad-int8",
             "--compress-moments", "--ckpt-every", "5",
             "--fail-at", "7", "--ckpt-dir", str(Path(tmp) / "ckpt"),
             "--device", str(device)])
        m, rec, restored = checked_training(targs, counters, device)
    params, opt_state = m["state"]
    leaves = list(tree_leaves(params))
    n_wire = sum(t.numel() >= gc_mod.QBLOCK for t in leaves)
    problems = training_problems(m, rec, n_wire, unfused)
    if m["restarts"] != 1 or m["steps_done"] != 12:
        problems.append(f"{m['restarts']} restarts, {m['steps_done']} steps")
    if [(s, d) for s, d, _ in restored] != [(5, True)] or \
            restored[0][2] != {device}:
        problems.append(f"restores {restored}")
    if problems:
        raise AssertionError("train: " + "; ".join(problems))
    log_training("(b) qwen3-1.7B", m, rec, targs, params)
    log(f"   restarts {m['restarts']} (failure at step 7), the restore of "
        f"step {restored[0][0]} on {restored[0][2].pop()} (device_out)")
    wire_step_ms(args, engine, leaves)
    train_launches = rec["launches"]
    del m, params, opt_state, leaves
    gc.collect()
    torch.cuda.empty_cache()

    # (c) 2 layers at full width in float32, TF32 off: card == CPU
    card_vs_cpu("(c) qwen3-1.7B", dataclasses.replace(
        get_arch("qwen3-1.7b"), n_layers=2, dtype="float32"), args.seed,
        device)
    log(f"   phase 11 launches: {train_launches}")
    return train_launches


# phase 12: the depth cuts of the served MoE, the two training runs and
# the float32 comparisons (the rwkv6 and zamba2 serves run whole)
FAMILY_SERVE_MOE_LAYERS = 4        # of 94: 11.2 B parameters, 22.4 GB bf16
FAMILY_TRAIN_MOE_LAYERS = 1        # 3.73 B parameters
FAMILY_TRAIN_HYBRID_LAYERS = 6     # the shared block applies once
FAMILY_TRAIN_STEPS = 6
FAMILY_CPU_LAYERS = {"rwkv6-1.6b": 2, "zamba2-2.7b": 6,
                     "qwen3-moe-235b-a22b": 2}
FAMILY_CPU_EXPERTS = 16            # of 128, so the CPU side stays small


def phase_families(args, engine, counters):
    """Phase 12: qwen3-moe-235B-A22B (4 layers), rwkv6-1.6B and zamba2-2.7B
    served at full width, the MoE (1 layer) and the hybrid (6 layers)
    trained through the loader and the int8 gradient wire, and each
    family on the card against the CPU in float32.  Returns the launches by
    kernel."""
    from repro_torch.roofline import analysis
    import gc
    from repro_torch.configs import get_arch
    from repro_torch.core.tree import leaves as tree_leaves
    from repro_torch.kernels import harness
    from repro_torch.launch import serve, train
    from repro_torch.optim import grad_compress as gc_mod
    log("== 12 the other families: qwen3-moe-235B-A22B "
        "(hf:Qwen/Qwen3-235B-A22B), rwkv6-1.6B (arXiv:2404.05892) and "
        "zamba2-2.7B (arXiv:2411.15242) served at full width, the MoE and "
        "the hybrid trained through the int8 gradient wire, card against "
        "CPU")
    device = engine.device
    for c in counters.values():
        c.reset()
    secs = {}

    def serve_args(arch, *extra):
        return serve.build_parser().parse_args(
            ["--arch", arch, "--preset", "full", "--batch", "8",
             "--prompt-len", "64", "--gen", "32", "--device", str(device),
             *extra])

    # (a)-(c) serve: 8 prompts of 64 tokens, 32 greedy tokens
    moe = get_arch("qwen3-moe-235b-a22b")
    t0 = time.perf_counter()
    sargs = serve_args(moe.name, "--n-layers", str(FAMILY_SERVE_MOE_LAYERS))
    log(f"   (a) depth cut {moe.n_layers} -> {FAMILY_SERVE_MOE_LAYERS} "
        f"layers; the check replays decode and runs forward at capacity "
        f"factor {moe.n_experts / moe.top_k:g} (= n_experts / top_k: C = T, "
        "no assignment dropped; decode's own C = 8 = T drops none either)")
    serve_and_check("(a) qwen3-moe-235B-A22B", sargs, device,
                    dataclasses.replace(
                        serve.resolve_cfg(sargs),
                        capacity_factor=moe.n_experts / moe.top_k))
    secs["(a)"] = time.perf_counter() - t0
    for label, arch in (("(b) rwkv6-1.6B", "rwkv6-1.6b"),
                        ("(c) zamba2-2.7B", "zamba2-2.7b")):
        t0 = time.perf_counter()
        serve_and_check(label, serve_args(arch), device)
        secs[label[:3]] = time.perf_counter() - t0
    log("   (c)'s bound reads the shared block once an application "
        f"({analysis.shared_apps(get_arch('zamba2-2.7b'))} a step)")

    # (d), (e) train: batch 8 x seq 512 from the driver's rle_v2 corpus,
    # int8 wire and moments, 6 steps, no failure injected
    (ROOT / "build").mkdir(exist_ok=True)
    unfused = harness.EPILOGUE_UNFUSED
    launches = {}
    for label, arch, layers in (
            ("(d) qwen3-moe-235B-A22B", moe.name, FAMILY_TRAIN_MOE_LAYERS),
            ("(e) zamba2-2.7B", "zamba2-2.7b", FAMILY_TRAIN_HYBRID_LAYERS)):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            targs = train.build_parser().parse_args(
                ["--arch", arch, "--preset", "full", "--n-layers",
                 str(layers), "--batch", "8", "--seq", "512", "--steps",
                 str(FAMILY_TRAIN_STEPS), "--lr", str(TRAIN_LR),
                 "--grad-int8", "--compress-moments", "--ckpt-dir",
                 str(Path(tmp) / "ckpt"), "--device", str(device)])
            log(f"   {label[:3]} depth cut {get_arch(arch).n_layers} -> "
                f"{layers} layers")
            m, rec, restored = checked_training(targs, counters, device)
        params = m["state"][0]
        leaves = list(tree_leaves(params))
        n_wire = sum(t.numel() >= gc_mod.QBLOCK for t in leaves)
        problems = training_problems(m, rec, n_wire, unfused)
        if m["restarts"] or m["steps_done"] != FAMILY_TRAIN_STEPS or \
                restored:
            problems.append(f"{m['restarts']} restarts, {m['steps_done']} "
                            f"steps, restores {restored}")
        if problems:
            raise AssertionError(f"{label} train: " + "; ".join(problems))
        log_training(label, m, rec, targs, params)
        tcfg = rec["cfg"]
        if tcfg.is_moe:
            T = targs.batch * targs.seq
            C = max(8, min(int(np.ceil(T * tcfg.top_k / tcfg.n_experts
                                       * tcfg.capacity_factor)), T))
            slots = tcfg.n_experts * C
            log(f"   capacity padding: {slots} expert slots a layer for "
                f"{T * tcfg.top_k} routed assignments (C = {C}): "
                f"{1 - T * tcfg.top_k / slots:.1%} of the expert work is "
                "padding, outside the bound")
            big = max(leaves, key=lambda t: t.numel())
            log(f"   largest wire leaf {tuple(big.shape)}: {big.numel()} "
                f"elements, {big.numel() // gc_mod.QBLOCK} rows of "
                f"{gc_mod.QBLOCK}, {big.numel() * 4 / 1e9:.2f} GB as float32")
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
        del m, params, leaves, rec
        gc.collect()
        torch.cuda.empty_cache()
        secs[label[:3]] = time.perf_counter() - t0

    # (f) card against CPU, float32
    t0 = time.perf_counter()
    for arch, layers in FAMILY_CPU_LAYERS.items():
        base = get_arch(arch)
        ccfg = dataclasses.replace(base, n_layers=layers, dtype="float32")
        cut = f"{base.n_layers} -> {layers} layers"
        if base.is_moe:
            ccfg = dataclasses.replace(ccfg, n_experts=FAMILY_CPU_EXPERTS)
            cut += f", experts {base.n_experts} -> {FAMILY_CPU_EXPERTS}"
        card_vs_cpu(f"(f) {arch} ({cut})", ccfg, args.seed, device,
                    decode=not base.is_moe)
    secs["(f)"] = time.perf_counter() - t0
    log("   phase 12 seconds: " + ", ".join(f"{k} {v:.1f}"
                                            for k, v in secs.items()))
    log(f"   phase 12 launches: {launches}")
    return launches


# phase 13: the collective plane
PSUM_LEAF = (151936, 2048)          # qwen3-1.7B's embedding: 311 M float32
PSUM_MEMBERS = (2, 4)
PSUM_CHECK_ROWS = 1 << 19           # output rows a slice of the plain check
CVC_SIZE = (1 << 20) + 77           # phase 13 (b)'s leaf, card against CPU
DILOCO_PODS = 2
DILOCO_OUTER_EVERY = 4
DILOCO_STEPS = {"int8": 12, "topk": 8}
DILOCO_TOPK = 0.01
BF16_ULP = 2.0 ** -8                # a bf16 anchor's rounding, relative


def reduce_plain_err(dev: dict, n: int, epi, out: torch.Tensor):
    """(max |out - plain|, plain ms) of the member reduce, the plain version
    (the bitpack body, ``Epilogue.apply`` with the ``MemberReduce``) run in
    slices of ``PSUM_CHECK_ROWS`` output rows, each slice's rows gathered
    from every member; ``inf`` where a slice's shape or dtype differs."""
    from repro_torch.kernels import bitpack
    words, scale = dev["comp_words"], dev["wire_scale"]
    nb = words.shape[0] // n
    err = 0.0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    plain_ms = 0.0
    for s0 in range(0, nb, PSUM_CHECK_ROWS):
        e0 = min(s0 + PSUM_CHECK_ROWS, nb)
        rows = [slice(m * nb + s0, m * nb + e0) for m in range(n)]
        part = {"comp_words": torch.cat([words[r] for r in rows]),
                "wire_scale": torch.cat([scale[r] for r in rows]),
                "wire_zero": dev["wire_zero"]}
        start.record()
        plain = epi.apply(bitpack.unpack(part["comp_words"], chunk_elems=128,
                                         width=1, bits=8), part)
        end.record()
        end.synchronize()
        plain_ms += start.elapsed_time(end)
        if plain.dtype != out.dtype or plain.shape != out[s0:e0].shape:
            return float("inf"), plain_ms
        err = max(err, float((plain - out[s0:e0]).abs().max()))
    return err, plain_ms


def reduce_bound_ms(n: int, nb: int) -> float:
    """The member reduce's least time: every member's wire rows (128 bytes
    of 8-bit fields) and float32 scales read once, the (nb, 128) float32
    output written once, at the card's memory rate."""
    from repro_torch.roofline import analysis
    return (n * nb * (128 + 4) + nb * 128 * 4) / analysis.HBM_BW * 1e3


def reduce_edge_cases(device) -> int:
    """The reduce entry against its plain version at the edges: a leaf not
    a multiple of 128 over 1, 2, 3 and 8 members, sum and mean, and a
    ragged gather.  Returns the number of cases (each must be equal)."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.engine import EngineConfig
    from repro_torch.distributed import collectives
    from repro_torch.kernels import bitpack, harness
    cases = 0
    g = torch.Generator(device=device).manual_seed(13)
    for n in (1, 2, 3, 8):
        x = torch.randn((n, 37 * 128 + 77), generator=g, device=device)
        dev = collectives.gathered_wire(x)
        for mean in (False, True):
            epi = harness.Epilogue(out_dtype="float32",
                                   scale_key="wire_scale",
                                   zero_key="wire_zero",
                                   fn=harness.MemberReduce(n, mean))
            before = bitpack.REDUCE_LAUNCHES
            out = plan_mod.dispatch(dev, config=EngineConfig(
                device=str(device)), codec="bitpack", width=1,
                chunk_elems=128, bits=8, epilogue=epi)
            err, _ = reduce_plain_err(dev, n, epi, out)
            if err != 0 or bitpack.REDUCE_LAUNCHES != before + 1:
                raise AssertionError(f"13 (a) reduce at n={n} mean={mean}: "
                                     f"max |err| {err}")
            cases += 1
    vals = torch.arange(2 * 3 * 128, device=device,
                        dtype=torch.int32).reshape(2, 3, 128) % 251
    tables = [collectives.wire_dev(collectives.pack_bits_rows(vals[m], 8),
                                   chunk_elems=128, bits=8) for m in (0, 1)]
    dev = plan_mod.gather_member_tables(tables, codec="bitpack",
                                        row_counts=[2, 3])
    if dev["out_lens"].tolist() != [128, 128, 0, 128, 128, 128]:
        raise AssertionError(f"13 (a) ragged out_lens {dev['out_lens']}")
    dev["wire_scale"] = torch.rand((6, 1), generator=g, device=device)
    dev["wire_zero"] = torch.full((), 127.0, device=device)
    epi = harness.Epilogue(out_dtype="float32", scale_key="wire_scale",
                           zero_key="wire_zero",
                           fn=harness.MemberReduce(2, False))
    out = plan_mod.dispatch(dev, config=EngineConfig(device=str(device)),
                            codec="bitpack", width=1, chunk_elems=128,
                            bits=8, epilogue=epi)
    err, _ = reduce_plain_err(dev, 2, epi, out)
    if err != 0:
        raise AssertionError(f"13 (a) ragged reduce: max |err| {err}")
    return cases + 1


def card_vs_cpu_collectives(device, seed: int) -> None:
    """13 (b): ``compressed_psum``, ``topk_psum`` and ``make_tree_reduce``
    (each wire) on 2- and 4-member meshes on the card against the port on
    the CPU, same inputs: within one int8 grid step (max |x| / 127 of the
    input each output comes from) elementwise; the share of elements that
    differ at all is printed."""
    from repro_torch.core.engine import EngineConfig
    from repro_torch.distributed import collectives
    from repro_torch.launch import mesh as mesh_lib
    rng = np.random.default_rng(seed + 13)

    def run(where: str, n: int, x, tree) -> dict:
        mesh = mesh_lib.make_test_mesh((n, 1), ("pod", "data"), device=where)
        cfg = EngineConfig(device=where)
        x = x.to(where)
        tree = {k: v.to(where) for k, v in tree.items()}
        out = {"psum": collectives.compressed_psum(x, mesh=mesh, config=cfg,
                                                   mean=True)}
        out["topk"], out["topk_res"] = collectives.topk_psum(
            x, torch.zeros_like(x), mesh=mesh, frac=DILOCO_TOPK, config=cfg,
            mean=True)
        for wire in ("int8", "topk", "none"):
            res = ({k: torch.zeros_like(v) for k, v in tree.items()}
                   if wire == "topk" else None)
            mean, new_res = collectives.make_tree_reduce(
                mesh, "pod", wire=wire, frac=DILOCO_TOPK, config=cfg)(
                tree, res)
            for k in tree:
                out[f"tree_{wire}_{k}"] = mean[k]
                if new_res is not None:
                    out[f"tree_{wire}_res_{k}"] = new_res[k]
        return {k: v.cpu() for k, v in out.items()}

    for n in (2, 4):
        x = torch.from_numpy(rng.standard_normal((n, CVC_SIZE)).astype(
            np.float32))
        tree = {"w": torch.from_numpy(rng.standard_normal(
                    (n, 4096, 300)).astype(np.float32)),
                "b": torch.from_numpy(rng.standard_normal((n, 77)).astype(
                    np.float32)),
                "e": torch.from_numpy((0.01 * rng.standard_normal(
                    (n, 1000, 129))).astype(np.float32))}
        got, want = run(str(device), n, x, tree), run("cpu", n, x, tree)
        groups = {}
        for key, w in want.items():
            src = x if not key.startswith("tree") else tree[key[-1]]
            d = (got[key] - w).abs()
            grid = float(src.abs().max()) / 127
            label = key.split("_")[0] if not key.startswith("tree") else \
                f"make_tree_reduce({key.split('_')[1]})"
            worst, differ, total = groups.get(label, (0.0, 0, 0))
            groups[label] = (max(worst, float(d.max()) / grid),
                             differ + int((d != 0).sum()), total + d.numel())
        bad = {k: v for k, v in groups.items() if v[0] > 1.0}
        if bad:
            raise AssertionError(f"13 (b) {n} members, card against CPU "
                                 f"beyond one grid step: {bad}")
        log(f"   (b) {n} members, card against CPU (worst, in int8 grid "
            "steps; elements that differ): " + "; ".join(
                f"{k} {w:.2e}, {d}/{t}" for k, (w, d, t) in groups.items()))


def checked_diloco(targs, counters, device) -> tuple:
    """``launch.train.run_training(targs)`` (``--diloco``) with its outer
    syncs held: after each sync every pod equals pod 0 exactly, and (int8
    wire) the anchor lies within the int8 grid bound of a float32 Nesterov
    step on the plain member mean of the same deltas: per leaf,
    lr * (1 + momentum) * max |delta| / 127 plus a bf16 rounding of the
    anchor.  The checks run on the sync's stream as device tensors and are
    read after the run.  Returns (the run's dict, the checks, the
    launches)."""
    from repro_torch.core.tree import leaves, map_tree
    from repro_torch.distributed import diloco
    from repro_torch.kernels import harness
    from repro_torch.launch import train
    real_make = diloco.make_outer_sync
    checks = []

    def make(mesh, cfg, **kw):
        sync = real_make(mesh, cfg, **kw)

        def held(pod_params, outer):
            new_pod, new_outer = sync(pod_params, outer)
            unequal = sum((p[1:] != p[:1]).sum() for p in leaves(new_pod))
            over = torch.zeros((), device=device)
            if cfg.wire == "int8":
                def excess(p, a, m, got):
                    d = (p - a[None].to(p.dtype)).float()
                    mean = harness.MemberReduce(d.shape[0], True).fold(d)
                    mom = cfg.outer_momentum * m + mean
                    ref = (a.float() + cfg.outer_lr
                           * (cfg.outer_momentum * mom + mean))
                    bound = (cfg.outer_lr * (1 + cfg.outer_momentum)
                             * d.abs().amax() / 127
                             + BF16_ULP * ref.abs())
                    return ((got.float() - ref).abs() - bound).amax()
                for args in zip(leaves(pod_params), leaves(outer["anchor"]),
                                leaves(outer["outer_mom"]),
                                leaves(new_outer["anchor"])):
                    over = torch.maximum(over, excess(*args))
            checks.append((unequal, over))
            return new_pod, new_outer

        return held

    from repro_torch.kernels import bitpack
    launches = {k: counters[k] for k in (kernel_of("rle_v2"),
                                         "bitpack_unpack")}
    # the reduce entry's count: phase 13's alone (the earlier phases hold
    # every counter of ``counters`` to a launch on their paths)
    launches["bitpack_reduce"] = Counter(bitpack, attr="REDUCE_LAUNCHES")
    for c in launches.values():
        c.reset()
    unfused = harness.EPILOGUE_UNFUSED
    diloco.make_outer_sync = make
    try:
        t0 = time.perf_counter()
        m = train.run_training(targs)
        torch.cuda.synchronize(device)
        m["run_s"] = time.perf_counter() - t0
    finally:
        diloco.make_outer_sync = real_make
    m["unfused"] = harness.EPILOGUE_UNFUSED - unfused
    held = [(int(u), float(o)) for u, o in checks]
    return m, held, {k: c.read() for k, c in launches.items()}


def sync_bound_ms(pod_params, outer) -> float:
    """An outer sync's least time: the pod params, the anchor and the
    float32 momentum read once, the new pods, anchor and momentum written
    once, at the card's memory rate."""
    from repro_torch.roofline import analysis
    nbytes = 2 * (analysis.tree_bytes(pod_params)
                  + analysis.tree_bytes(outer["anchor"])
                  + analysis.tree_bytes(outer["outer_mom"]))
    return nbytes / analysis.HBM_BW * 1e3


def phase_collectives(args, engine, counters):
    """Phase 13: the member reduce fused into bitpack's stores on
    qwen3-1.7B's embedding leaf, the collectives on the card against the
    CPU, and DiLoCo training through ``launch/train.py --diloco``.  Returns
    (the reduce entry's row of the kernels line, the DiLoCo run's launches
    by kernel)."""
    from repro_torch.roofline import analysis
    import gc
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.tree import leaves
    from repro_torch.distributed import collectives, diloco
    from repro_torch.kernels import bitpack, harness
    from repro_torch.launch import mesh as mesh_lib, train
    log("== 13 the collective plane: compressed_psum's dequant -> member "
        "reduce in bitpack's stores (codag_bitpack_reduce) on qwen3-1.7B's "
        "embedding leaf, the collectives card against CPU, and qwen3-1.7B "
        "DiLoCo training (2 pods sharing the card)")
    device = engine.device
    secs = {}
    t0 = time.perf_counter()

    # (a) the reduce entry against its plain version, timed against its
    # bound, at full size; then the edge cases
    rows = {}
    size = PSUM_LEAF[0] * PSUM_LEAF[1]
    cfg_e = EngineConfig(device=str(device))
    for n in PSUM_MEMBERS:
        g = torch.Generator(device=device).manual_seed(args.seed + n)
        x = torch.randn((n, size), generator=g, device=device)
        dev = collectives.gathered_wire(x)
        del x
        nb = dev["comp_words"].shape[0] // n
        epi = harness.Epilogue(out_dtype="float32", scale_key="wire_scale",
                               zero_key="wire_zero",
                               fn=collectives._member_reduce(n, True))

        def reduce_once():
            return plan_mod.dispatch(dev, config=cfg_e, codec="bitpack",
                                     width=1, chunk_elems=128, bits=8,
                                     epilogue=epi)

        before = (bitpack.REDUCE_LAUNCHES, bitpack.LAUNCHES,
                  harness.EPILOGUE_UNFUSED)
        out = reduce_once()
        torch.cuda.synchronize()
        if (bitpack.REDUCE_LAUNCHES - before[0], bitpack.LAUNCHES - before[1],
                harness.EPILOGUE_UNFUSED - before[2]) != (1, 0, 0):
            raise AssertionError("13 (a): the reduce was not one fused "
                                 "codag_bitpack_reduce launch")
        err, plain_ms = reduce_plain_err(dev, n, epi, out)
        del out
        ms = ms_of(reduce_once, args.reps)
        dms = device_ms(reduce_once, args.reps, sleep_cycles=20_000_000)
        bound = reduce_bound_ms(n, nb)
        rows[n] = {"max_abs_err": err, "ms": ms, "device_ms": dms,
                   "plain_ms": plain_ms, "bound_ms": bound}
        log(f"   (a) {n} members x {nb} rows of 128 ({PSUM_LEAF[0]} x "
            f"{PSUM_LEAF[1]} float32 a member), mean: one "
            f"codag_bitpack_reduce launch, max |err| against the plain "
            f"version {err} (slices of {PSUM_CHECK_ROWS} rows); ms "
            f"{ms:.3f}, device {dms:.3f} (median of {args.reps}); bound "
            f"{bound:.3f} ms (bytes: {n} x {nb} x 132 B read, {nb} x 512 B "
            f"written, at {analysis.HBM_BW / 1e12:.2f} TB/s), "
            f"{bound / dms:.1%} of it; plain version {plain_ms:.3f} ms")
        if err != 0:
            raise AssertionError(f"13 (a) reduce at {n} members differs from "
                                 f"its plain version by {err}")
        del dev
        gc.collect()
        torch.cuda.empty_cache()
    cases = reduce_edge_cases(device)
    log(f"   (a) edge cases: {cases} (a leaf of 37 x 128 + 77 over 1, 2, 3 "
        "and 8 members, sum and mean; a ragged gather), each == the plain "
        "version bit for bit")
    secs["(a)"] = time.perf_counter() - t0

    # (b) card against CPU
    t0 = time.perf_counter()
    card_vs_cpu_collectives(device, args.seed)
    secs["(b)"] = time.perf_counter() - t0

    # (c) DiLoCo training through the driver, int8 then top-k outer wire
    (ROOT / "build").mkdir(exist_ok=True)
    launches = {}
    for wire, steps in DILOCO_STEPS.items():
        t0 = time.perf_counter()
        extra = (["--outer-wire", "int8"] if wire == "int8"
                 else ["--topk", str(DILOCO_TOPK)])
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            targs = train.build_parser().parse_args(
                ["--arch", "qwen3-1.7b", "--preset", "full", "--n-layers",
                 str(TRAIN_LAYERS), "--batch", "8", "--seq", "512",
                 "--steps", str(steps), "--lr", str(TRAIN_LR),
                 "--grad-int8", "--compress-moments", "--diloco",
                 str(DILOCO_PODS), "--outer-every", str(DILOCO_OUTER_EVERY),
                 "--ckpt-dir", str(Path(tmp) / "ckpt"), "--device",
                 str(device), *extra])
            m, held, run_launches = checked_diloco(targs, counters, device)
        losses = m["losses"]
        k = max(1, len(losses) // 10)
        pod_params, _, outer = m["state"]
        n_wire = sum(t[0].numel() >= 128 for t in leaves(pod_params))
        syncs = m["overlap"]["syncs"]
        problems = []
        if not float(np.mean(losses[-k:])) < float(np.mean(losses[:k])):
            problems.append(f"loss did not fall: {losses}")
        # a sync launched every DILOCO_OUTER_EVERY steps after the first,
        # each finished by the next or after the last step
        if syncs != len(held) or \
                syncs != (steps - 1) // DILOCO_OUTER_EVERY:
            problems.append(f"{syncs} syncs, {len(held)} checked")
        if any(u for u, _ in held):
            problems.append(f"pods differ after a sync: {held}")
        if wire == "int8" and any(o > 0 for _, o in held):
            problems.append(f"anchor beyond the int8 grid bound: {held}")
        if wire == "int8" and (run_launches["bitpack_reduce"]
                               != n_wire * syncs or m["unfused"]):
            problems.append(f"{run_launches['bitpack_reduce']} reduce "
                            f"launches for {n_wire} leaves x {syncs} syncs,"
                            f" {m['unfused']} unfused epilogues")
        if run_launches[kernel_of("rle_v2")] < 1 or \
                run_launches["bitpack_unpack"] < DILOCO_PODS * n_wire * steps:
            problems.append(f"launches {run_launches}")
        if problems:
            raise AssertionError(f"13 (c) {wire}: " + "; ".join(problems))
        step_s = float(np.median(m["step_seconds"]))
        ov, wrep = m["overlap"], m["wire"]
        log(f"   (c) {wire} outer wire: qwen3-1.7B at {TRAIN_LAYERS} layers, "
            f"{DILOCO_PODS} pods x batch {targs.batch} x seq {targs.seq}, "
            f"--grad-int8 --compress-moments, lr {targs.lr}, outer every "
            f"{DILOCO_OUTER_EVERY}, {steps} steps in {m['run_s']:.2f} s; "
            f"losses {', '.join(f'{v:.4f}' for v in losses)}: first "
            f"{np.mean(losses[:k]):.4f} -> last {np.mean(losses[-k:]):.4f}; "
            f"step {step_s * 1e3:.2f} ms (median, host clock, both pods)")
        log(f"   syncs {syncs}: pods equal after each; "
            + ("anchor within the int8 grid bound of a float32 Nesterov step "
               f"on the plain member mean (worst excess "
               f"{max(o for _, o in held):.3e} <= 0); "
               if wire == "int8" else "")
            + f"overlap {json.dumps(ov)}; wire_report {json.dumps(wrep)} "
            f"({wrep['ratio']:.2f}x)")
        sync = diloco.make_outer_sync(
            mesh_lib.make_test_mesh((DILOCO_PODS, 1), ("pod", "data"),
                                    device=str(device)),
            diloco.DiLoCoConfig(wire=wire, topk_frac=DILOCO_TOPK),
            config=cfg_e)
        sync_ms = device_ms(lambda: sync(pod_params, outer), 3,
                            sleep_cycles=40_000_000)
        sbound = sync_bound_ms(pod_params, outer)
        log(f"   one {wire} sync alone: device {sync_ms:.3f} ms (median of "
            f"3); bound {sbound:.3f} ms (pods, anchor and float32 momentum "
            f"read and written once), the sync {sync_ms / sbound:.1f}x it; "
            f"launches in the run {run_launches}")
        for name, v in run_launches.items():
            launches[name] = launches.get(name, 0) + v
        del m, pod_params, outer, sync
        gc.collect()
        torch.cuda.empty_cache()
        secs[f"(c) {wire}"] = time.perf_counter() - t0
    log("   phase 13 seconds: " + ", ".join(f"{k} {v:.1f}"
                                            for k, v in secs.items()))
    log(f"   phase 13 launches: {launches}")
    row = rows[PSUM_MEMBERS[0]]
    return {
        "name": "bitpack_reduce",
        "route": "cuda",
        "source": "src/repro_torch/csrc/bitpack_unpack.cu",
        "replaces": "src/repro/kernels/bitpack.py:55",
        "launches": launches["bitpack_reduce"],
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": row["ms"], "device_ms": row["device_ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "members": PSUM_MEMBERS[0],
        "by_members": {str(n): r for n, r in rows.items()},
        "diloco_launches": launches["bitpack_reduce"],
    }, launches


# --------------------------------------------------------------------------
# phase 14: mesh placement on one card
# --------------------------------------------------------------------------


def moments_card_vs_cpu(seed: int, device) -> dict:
    """(d) ``optim/adamw.py``'s int8 quantizer on the card against the same
    on the CPU, on float32 moments of the shapes of phase 11 (b)'s block
    parameters (qwen3-1.7B at full width, ``TRAIN_LAYERS`` layers; the
    embedding and head left out for time): m linear, v in the sqrt domain.
    Returns the elements of ``q`` and ``s`` that differ, and how many there
    are."""
    from repro_torch.configs import get_arch
    from repro_torch.core.tree import leaves
    from repro_torch.models import model
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(get_arch("qwen3-1.7b"), n_layers=TRAIN_LAYERS)
    gen = torch.Generator(device=device).manual_seed(seed)
    res = {"q": 0, "q_of": 0, "s": 0, "s_of": 0, "leaves": 0}
    for p in leaves(model.abstract_params(cfg)["blocks"]):
        g = torch.randn(p.shape, generator=gen, device=device)
        # the moments of one step of gradients of 1e-3: (1 - b1) g and
        # (1 - b2) g^2
        for x, sqrt_domain in ((1e-4 * g, False), (5e-8 * g * g, True)):
            q, s = adamw._quantize(x, sqrt_domain)
            qc, sc = adamw._quantize(x.cpu(), sqrt_domain)
            res["q"] += int((q.cpu() != qc).sum())
            res["s"] += int((s.cpu() != sc).sum())
            res["q_of"] += qc.numel()
            res["s_of"] += sc.numel()
            res["leaves"] += 1
            del q, s, qc, sc, x
        del g
    return res


SHARDED_MEMBERS = 4                # (a): then the least count >= 3 that
                                   # pads every group
ELASTIC_MESHES = (((2, 2), "data=2, model=2"), ((4, 1), "data=4, model=1"),
                  ((1, 4), "data=1, model=4"))


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes, dtypes and bits (torch compares no uint32 on a card)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                       b.contiguous().reshape(-1).view(torch.uint8))


def shard_problems(got, want: torch.Tensor, sh, sharding) -> list:
    """``got`` placed as ``sh`` places ``want``: each member's shard the
    matching block of ``want``, bit for bit, on the member's device, in a
    storage of its own; or, where ``want``'s shape cannot be placed, a
    tensor equal to it."""
    if not isinstance(got, sharding.ShardedTensor):
        return [] if not sharding.placeable(want.shape, sh) and \
            bits_equal(got, want) else ["not placed, or differs"]
    bad = []
    if got.sharding is not sh or tuple(got.shape) != tuple(want.shape):
        bad.append(f"placed as {got.sharding}, {tuple(got.shape)}")
    ptrs = {s.data_ptr() for s in got.shards if s.numel()}
    if len(ptrs) != sum(1 for s in got.shards if s.numel()):
        bad.append("members share a storage")
    for m, (idx, shard, dev) in enumerate(zip(
            sh.member_indices(want.shape), got.shards,
            sh.mesh.devices.flat)):
        if shard.device != dev or not bits_equal(shard, want[idx]):
            bad.append(f"member {m}")
    return bad


def sharded_scan(args, data, engine, counters, plan_mod, transfers,
                 sharding, mesh_lib) -> dict:
    """(a) phase 4's table scan through ``decompress_many(mesh=,
    out_shardings=decode_out_sharding)`` on ``SHARDED_MEMBERS`` members
    sharing the card, then on the least count that pads every group with
    zero-length rows; every shard against phase 4's ``execute_device``
    output; the staged plan's device time beside ``execute_device``'s; and
    the padded plan through ``all_thread=False``.  Returns the launches of
    the counted calls."""
    from repro_torch.core import api
    from repro_torch.core.engine import CodagEngine
    from repro_torch.kernels import scalar
    device = engine.device
    cas = data["cas"]
    flat = [b for ca in cas for b in ca.blobs]
    refs = api.decompress_many(cas, engine, device_out=True)
    sync(device)
    launched: dict = {}
    rows = [g.num_chunks for g in plan_mod.DecodePlan.build(flat).groups]
    padding = next(n for n in range(3, 64) if all(r % n for r in rows))
    for n in (SHARDED_MEMBERS, padding):
        mesh = mesh_lib.make_test_mesh((n,), ("data",), device=str(device))
        shs = [sharding.decode_out_sharding(mesh, a.ndim)
               for a in data["arrays"]]
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        outs = api.decompress_many(cas, engine, mesh=mesh, out_shardings=shs)
        sync(device)
        first_s = time.perf_counter() - t0
        got = {k: c.read() for k, c in counters.items() if c.read()}
        for k, v in got.items():
            launched[k] = launched.get(k, 0) + v
        plan = plan_mod.DecodePlan.build(flat)
        if sum(got.values()) != plan.num_dispatches:
            raise AssertionError(f"(a) {n} members: {sum(got.values())} "
                                 f"launches for {plan.num_dispatches} groups")
        bad, placed = [], 0
        for i, (o, r, sh) in enumerate(zip(outs, refs, shs)):
            placed += isinstance(o, sharding.ShardedTensor)
            bad += [(i, p) for p in shard_problems(o, r, sh, sharding)]
        if bad:
            raise AssertionError(f"(a) {n} members: {bad[:5]}")
        pads = [-(-g.num_chunks // n) * n - g.num_chunks
                for g in plan.groups]
        del outs
        # the same plan staged: build, staging, decode and placement apart
        t0 = time.perf_counter()
        plan = plan_mod.DecodePlan.build(flat)
        build_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        with transfers.count_host_transfers() as h2d:
            plan.stage_sharded(mesh, "data")
        sync(device)
        stage_ms = (time.perf_counter() - t0) * 1e3
        blob_sh = [None] * len(flat)
        pos = 0
        for ca, sh in zip(cas, shs):
            if len(ca.blobs) == 1:
                blob_sh[pos] = sh
            pos += len(ca.blobs)
        plan.execute_sharded(mesh, engine=engine, out_shardings=blob_sh)
        plan.stage(device)
        plan.execute_device(engine)
        sync(device)

        def guarded(fn):
            def run():
                with transfers.no_host_transfers():
                    fn()
            return run

        dec_ms = ms_of(guarded(lambda: plan.execute_sharded(
            mesh, engine=engine)), args.reps)
        placed_ms = ms_of(guarded(lambda: plan.execute_sharded(
            mesh, engine=engine, out_shardings=blob_sh)), args.reps)
        dev_ms = ms_of(guarded(lambda: plan.execute_device(engine)),
                       args.reps)
        e2e = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            o = api.decompress_many(cas, engine, mesh=mesh,
                                    out_shardings=shs)
            sync(device)
            e2e.append(time.perf_counter() - t0)
            del o
        with transfers.count_host_transfers() as c:
            with transfers.no_host_transfers():
                plan.execute_sharded(mesh, engine=engine,
                                     out_shardings=blob_sh)
            sync(device)
        if c["d2h"] or c["h2d"]:
            raise AssertionError(f"(a) {n} members: the staged plan moved "
                                 f"{c} across the host link")
        log(f"   (a) {n} members: decompress_many(mesh=, out_shardings="
            f"decode_out_sharding): {sum(got.values())} launches for "
            f"{plan.num_dispatches} groups {got}; padding rows a group "
            f"{pads}; {placed} of {len(cas)} arrays placed, every "
            f"shard equal to phase 4's execute_device output bit for bit "
            f"(the rest not placeable, equal whole); first call "
            f"{first_s * 1e3:.1f} ms")
        log(f"       end to end median {np.median(e2e) * 1e3:.2f} ms over "
            f"{args.reps}; of one call DecodePlan.build {build_ms:.2f} ms, "
            f"stage_sharded {stage_ms:.2f} ms ({h2d['h2d']} uploads, "
            f"{h2d['h2d_bytes'] / 2**20:.1f} MiB); staged, no host transfer "
            f"(0 d2h, 0 h2d): execute_sharded {dec_ms:.3f} ms without "
            f"placement, {placed_ms:.3f} ms placed (placement "
            f"{placed_ms - dec_ms:.3f} ms), execute_device {dev_ms:.3f} ms "
            "in the same call")
        if n == padding:
            # the single-thread kernel through the padded groups
            seng = CodagEngine(dataclasses.replace(engine.config,
                                                   all_thread=False))
            scalar.LAUNCHES = 0
            t0 = time.perf_counter()
            outs = plan.execute_sharded(mesh, engine=seng,
                                        out_shardings=blob_sh)
            sync(device)
            s_ms = (time.perf_counter() - t0) * 1e3
            launched["scalar_decode"] = scalar.LAUNCHES
            bad = []
            for i, (o, r, sh) in enumerate(zip(
                    outs, plan.execute_device(engine), blob_sh)):
                if sh is None:
                    bad += [] if bits_equal(o, r) else [(i, "differs")]
                else:
                    bad += [(i, p) for p in shard_problems(o, r, sh,
                                                           sharding)]
            if bad or scalar.LAUNCHES != plan.num_dispatches:
                raise AssertionError(f"(a) all_thread=False: {bad[:5]}, "
                                     f"{scalar.LAUNCHES} launches")
            log(f"       all_thread=False (scalar_decode.cu) through the "
                f"{n}-member padded groups: {scalar.LAUNCHES} launches, "
                f"{s_ms:.1f} ms, every shard equal bit for bit")
            del outs
        del plan
        torch.cuda.empty_cache()
    del refs
    return launched
def moment_like(layers: int):
    """(the structure of phase 10 (a)'s state, the AdamW state's and the
    parameters' shapes as ``meta`` tensors) for ``opt_shardings``."""
    meta = lambda *shape: torch.empty(shape, device="meta")
    params = {f"layer{i:02d}": {
        name: meta(n) for name, n in
        [(nm, k * m) for nm, k, m in QWEN3_PROJECTIONS]
        + [(nm, D_MODEL) for nm in QWEN3_NORMS]} for i in range(layers)}

    def moment(p):
        return {"q": meta(p.shape[0] // QBLOCK, QBLOCK),
                "s": meta(p.shape[0] // QBLOCK, 1)}

    opt = {"step": meta(), "m": {}, "v": {}}
    for which in ("m", "v"):
        opt[which] = {lk: {nm: moment(p) for nm, p in lp.items()}
                      for lk, lp in params.items()}
    return opt, params


def kv_like(sharding, mesh):
    """Phase 10 (b)'s state (one layer's K and V projections, bf16) and its
    parameter shardings, by the reference's rule names (``attn/wk``,
    ``attn/wv``: the output dimension over ``model``)."""
    meta = {name: torch.empty((k, n), dtype=torch.bfloat16, device="meta")
            for name, k, n in QWEN3_PROJECTIONS if name in ("k", "v")}
    sh = sharding.param_shardings({"attn": {"wk": meta["k"],
                                            "wv": meta["v"]}}, mesh)
    return meta, {"k": sh["attn"]["wk"], "v": sh["attn"]["wv"]}


def sharded_restores(args, keep: Path, engine, counters, sharding, mesh_lib,
                     ckpt, transfers, store_mod) -> dict:
    """(b) phase 10's two checkpoints restored with ``shardings=`` onto
    (data=2, model=2), then elastically onto (data=4, model=1) and (data=1,
    model=4), each through the engine path and through a store, with
    ``device_out``: every shard against the unsharded restore's block, no
    device->host transfer.  Returns the launches."""
    device = engine.device
    launched: dict = {}
    cases = (("moments", "bitpack AdamW int8 moments"),
             ("weights", "tdeflate bf16 K and V"))
    for dirname, label in cases:
        root = keep / dirname
        sync(device)
        t0 = time.perf_counter()
        if dirname == "moments":
            opt_meta, params_meta = moment_like(args.ckpt_layers)
            like = opt_meta
        else:
            like = kv_like(sharding, mesh_lib.make_test_mesh(
                (1, 1), ("data", "model"), device=str(device)))[0]
        plain = ckpt._flatten(ckpt.restore(str(root), 1, like, engine=engine,
                                           device_out=True))
        sync(device)
        plain_s = time.perf_counter() - t0
        times = []
        for shape, mname in ELASTIC_MESHES:
            mesh = mesh_lib.make_test_mesh(shape, ("data", "model"),
                                           device=str(device))
            if dirname == "moments":
                shs = sharding.opt_shardings(opt_meta, params_meta, mesh)
            else:
                shs = kv_like(sharding, mesh)[1]
            flat_sh = ckpt._flatten(shs)
            for way in ("engine", "store"):
                for c in counters.values():
                    c.reset()
                sync(device)
                t0 = time.perf_counter()
                with transfers.count_host_transfers() as moved:
                    if way == "store":
                        with store_mod.filesystem_store(root) as st:
                            out = ckpt.restore(str(root), 1, like,
                                               shardings=shs, engine=engine,
                                               device_out=True, store=st)
                            sync(device)
                    else:
                        out = ckpt.restore(str(root), 1, like, shardings=shs,
                                           engine=engine, device_out=True)
                    sync(device)
                dt = time.perf_counter() - t0
                got = {k: c.read() for k, c in counters.items() if c.read()}
                for k, v in got.items():
                    launched[k] = launched.get(k, 0) + v
                flat_out = ckpt._flatten(out)
                bad = [(k, p) for k in plain for p in shard_problems(
                    flat_out[k], plain[k], flat_sh[k], sharding)]
                if bad or moved["d2h"]:
                    raise AssertionError(f"(b) {label} onto {mname} ({way}): "
                                         f"{bad[:5]}, {moved['d2h']} d2h")
                placed = sum(isinstance(v, sharding.ShardedTensor)
                             for v in flat_out.values())
                times.append(dt)
                log(f"   (b) {label} onto ({mname}), {way}: {dt:.3f} s, "
                    f"{placed} of {len(plain)} leaves placed, every shard "
                    f"equal to the unsharded restore's block, "
                    f"{moved['d2h']} d2h; launches {got}")
                del out, flat_out
        log(f"   (b) {label}: unsharded device_out restore {plain_s:.3f} s "
            f"(phase 10's 0.386 s was the moments' at 4 layers, PR 19); "
            f"sharded restores {min(times):.3f}-{max(times):.3f} s")
        del plain
    return launched


def sharded_loader(args, keep: Path, engine, counters, sharding, mesh_lib,
                   pipeline, store_mod) -> dict:
    """(c) one epoch of phase 10's spilled corpus through
    ``CompressedLoader(mesh=)`` on a 2-member ``data`` mesh, every batch's
    ``full()`` against engine mode's; tokens/s.  Returns the launches."""
    device = engine.device
    shards = keep / "shards"
    keys = sorted(p.name for p in shards.glob("shard_*.blob"))
    st = store_mod.filesystem_store(shards)
    store = pipeline.CompressedTokenStore([], VOCAB, store=st, keys=keys)
    mesh = mesh_lib.make_test_mesh((2,), ("data",), device=str(device))
    bsh = sharding.decode_out_sharding(mesh, 2)
    per = LOADER_BATCH * LOADER_SEQ
    n_batches = (args.corpus_tokens - 1) // per
    for c in counters.values():
        c.reset()
    it = iter(pipeline.CompressedLoader(store, LOADER_BATCH, LOADER_SEQ,
                                        engine=engine, decode_window=4,
                                        mesh=mesh))
    sync(device)
    t0 = time.perf_counter()
    got = [next(it) for _ in range(n_batches)]
    sync(device)
    dt = time.perf_counter() - t0
    it.close()
    launched = {k: c.read() for k, c in counters.items() if c.read()}
    it = iter(pipeline.CompressedLoader(store, LOADER_BATCH, LOADER_SEQ,
                                        engine=engine, decode_window=4,
                                        device_out=True))
    bad = 0
    for b in got:
        want = next(it)
        for k in ("tokens", "labels"):
            if not isinstance(b[k], sharding.ShardedTensor) or \
                    b[k].sharding != bsh or \
                    not bits_equal(b[k].full(), want[k]):
                bad += 1
    it.close()
    st.close()
    if bad:
        raise AssertionError(f"(c) {bad} mesh loader batches differ from "
                             "engine mode's")
    log(f"   (c) CompressedLoader(mesh=) on 2 members: {n_batches} batches "
        f"of {LOADER_BATCH} x {LOADER_SEQ} in {dt:.3f} s = "
        f"{n_batches * per / dt:.0f} tokens/s, each placed over its batch "
        f"dimension and its full() equal to engine mode's bit for bit; "
        f"launches {launched}")
    return launched


def phase_sharded(args, engine, counters, data=None, keep=None) -> dict:
    """Phase 14: mesh placement on meshes whose members share the card:
    (a) phase 4's table scan through the sharded executor, (b) phase 10's
    checkpoints restored with ``shardings=``, (c) the loader's ``mesh=``,
    (d) the int8 moments' quantizer card against CPU.  ``data`` and
    ``keep`` are phase 4's workload and phase 10's files; without them
    (``--sharded-only``) both are made here.  Returns the launches by
    kernel of (a)-(c)."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import api, plan as plan_mod, transfers
    from repro_torch.core import store as store_mod
    from repro_torch.data import pipeline
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_lib
    log("== 14 mesh placement: the sharded decode executor, restore("
        "shardings=), the loader's mesh=, members sharing the card")
    device = engine.device
    t0 = time.perf_counter()
    launched: dict = {}

    def count(got):
        for k, v in got.items():
            launched[k] = launched.get(k, 0) + v

    made = None
    if data is None:
        data = main_data(args, np.random.default_rng(args.seed), api)
    if keep is None:
        (ROOT / "build").mkdir(exist_ok=True)
        made = tempfile.TemporaryDirectory(dir=ROOT / "build")
        keep = Path(made.name)
        save_phase10_files(args, keep, device, ckpt, pipeline)
    try:
        t1 = time.perf_counter()
        count(sharded_scan(args, data, engine, counters, plan_mod, transfers,
                           sharding, mesh_lib))
        secs = {"a": time.perf_counter() - t1}
        t1 = time.perf_counter()
        count(sharded_restores(args, keep, engine, counters, sharding,
                               mesh_lib, ckpt, transfers, store_mod))
        secs["b"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        count(sharded_loader(args, keep, engine, counters, sharding,
                             mesh_lib, pipeline, store_mod))
        secs["c"] = time.perf_counter() - t1
    finally:
        if made is not None:
            made.cleanup()
    # (d) the int8 moments' quantizer, card against CPU
    t1 = time.perf_counter()
    res = moments_card_vs_cpu(args.seed, device)
    secs["d"] = time.perf_counter() - t1
    log(f"   (d) optim/adamw.py's int8 quantizer on {res['leaves']} moment "
        f"leaves (qwen3-1.7B's blocks, {TRAIN_LAYERS} layers), card against "
        "CPU: "
        f"{res['q']} of {res['q_of']} q elements and {res['s']} of "
        f"{res['s_of']} scales differ")
    if res["q"] or res["s"]:
        raise AssertionError("(d) the int8 moments differ between the card "
                             "and the CPU")
    missing = [k for k in ("two_phase_rle<rle_v1>", "two_phase_rle<rle_v2>",
                           "two_phase_rle<dbp>", "bitpack_unpack",
                           "tdeflate_decode", "huffman_decode", "lzss_decode",
                           "scalar_decode") if launched.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"phase 14 launched no {missing}")
    log(f"   phase 14: {time.perf_counter() - t0:.1f} s ((a) {secs['a']:.1f},"
        f" (b) {secs['b']:.1f}, (c) {secs['c']:.1f}, (d) {secs['d']:.1f}); "
        f"launches {launched}")
    return launched


# phase 15: the model's steps under a mesh of the card
MESH = "2x2x2"                     # (pod 2, data 2, model 2), shared card
MESH_TRAIN_STEPS = 6
MESH_MOE_BATCH, MESH_MOE_SEQ = 8, 128
ELASTIC_FROM, ELASTIC_TO = "4x2", "2x2"


def trees_equal(a, b) -> list:
    """The keys where two trees (``ShardedTensor`` leaves gathered)
    differ in shape, dtype or bits."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.distributed import sharding
    fa = ckpt._flatten(sharding.gather(a))
    fb = ckpt._flatten(sharding.gather(b))
    if sorted(fa) != sorted(fb):
        return ["(the keys)"]
    return [k for k in fa if not (
        fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape
        and torch.equal(bit_view(fa[k]), bit_view(fb[k])))]


def mesh_training(counters, device, train, extra, tmp: Path, drawn=None):
    """``checked_training`` of phase 11 (b)'s run (4 full-width qwen3-1.7B
    layers, 8 x 512, ``--grad-int8 --compress-moments``) with ``extra``
    flags, its checks held; returns (the run's dict, its record)."""
    from repro_torch.core.tree import leaves as tree_leaves
    from repro_torch.kernels import harness
    from repro_torch.optim import grad_compress as gc_mod
    targs = train.build_parser().parse_args(
        ["--arch", "qwen3-1.7b", "--preset", "full", "--n-layers",
         str(TRAIN_LAYERS), "--batch", "8", "--seq", "512", "--lr",
         str(TRAIN_LR), "--grad-int8", "--compress-moments", "--ckpt-dir",
         str(tmp), "--device", str(device), *extra])
    unfused = harness.EPILOGUE_UNFUSED
    m, rec, restored = checked_training(targs, counters, device, drawn)
    n_wire = sum(int(np.prod(t.shape)) >= gc_mod.QBLOCK
                 for t in tree_leaves(m["state"][0]))
    problems = training_problems(m, rec, n_wire, unfused)
    if problems:
        raise AssertionError(f"train {extra}: " + "; ".join(problems))
    m["targs"], m["n_wire"], m["restored"] = targs, n_wire, restored
    return m, rec


def mesh_step_parts(tcfg, base_state, device, policy: str,
                    reps: int = 3) -> dict:
    """One sharded train step on ``MESH`` cut into its parts, from phase
    15 (a)'s unsharded state on random tokens: the milliseconds (host
    clock between device synchronisations, median of the last
    ``reps - 1`` steps) of placing the inputs and the outputs, the
    all-gathers, the batched forward and backward with the wire, and the
    members' AdamW updates."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.core.engine import EngineConfig
    from repro_torch.distributed import collectives, sharding
    from repro_torch.launch import mesh as mesh_lib, steps
    from repro_torch.optim import adamw
    oc = adamw.AdamWConfig(lr=TRAIN_LR, compress_moments=True)
    step = steps.build_train_step(tcfg, oc, grad_compressor=collectives
                                  .make_wire_compressor(
                                      EngineConfig(device=str(device))))
    parts: dict = {}
    depth = [0]

    def timed(name, fn):
        def run(*a, **kw):           # the outermost call of a recursion
            if depth[0]:
                return fn(*a, **kw)
            depth[0] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
                torch.cuda.synchronize()
            finally:
                depth[0] -= 1
            parts.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return run

    real = (sharding.gather, sharding.place, steps._zero1_apply)
    step.loss_and_grads = timed("forward + backward + wire",
                                step.loss_and_grads)
    mesh = mesh_lib.parse_mesh(MESH, device=str(device))
    with sharding.use_mesh(mesh, policy):
        ins, outs = steps.train_shardings(
            tcfg, ShapeSpec("train", 512, 8, "train"), mesh, oc)
        fn = steps.sharded_step(step, ins, outs)
    gen = torch.Generator(device=device).manual_seed(1)
    batch = {k: torch.randint(0, tcfg.vocab, (8, 512), generator=gen,
                              device=device, dtype=torch.int32)
             for k in ("tokens", "labels")}
    state = sharding.place(base_state, ins[:2])
    sharding.gather, sharding.place = (timed("all-gather", real[0]),
                                       timed("placement", real[1]))
    steps._zero1_apply = timed("members' AdamW", real[2])
    per_step = []
    try:
        for _ in range(reps):
            parts.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, o, _ = fn(*state, batch)
            torch.cuda.synchronize()
            state = (p, o)
            per_step.append((time.perf_counter() - t0,
                             {k: sum(v) for k, v in parts.items()}))
    finally:
        sharding.gather, sharding.place, steps._zero1_apply = real
    kept = per_step[1:]
    out = {k: float(np.median([d[k] for _, d in kept])) * 1e3
           for k in kept[0][1]}
    out["step"] = float(np.median([t for t, _ in kept])) * 1e3
    return out


def phase_mesh(args, engine, counters) -> dict:
    """Phase 15: the model's train, prefill and serve steps under a mesh of
    the card (``launch.steps.sharded_step``), each against the same work
    without a mesh, and the runner's elastic restart onto a smaller mesh.
    Returns the launches by kernel."""
    from repro_torch.roofline import analysis
    import gc
    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.core.engine import EngineConfig
    from repro_torch.distributed import collectives, sharding
    from repro_torch.launch import mesh as mesh_lib, serve, steps, train
    from repro_torch.models import model
    from repro_torch.optim import adamw
    log("== 15 the model's steps under a mesh of the card: qwen3-1.7B "
        f"trained and served on a ({MESH}) pod x data x model mesh, "
        "qwen3-moe-235B-A22B prefilled per DP group, the elastic restart "
        f"{ELASTIC_FROM} -> {ELASTIC_TO} [{CARD['label']}]")
    device = engine.device
    for c in counters.values():
        c.reset()
    launched: dict = {}
    secs = {}

    def add(rec):
        for k, v in rec["launches"].items():
            launched[k] = launched.get(k, 0) + v

    # (a) train MESH_TRAIN_STEPS steps on the mesh under both policies,
    # against the same steps without a mesh
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        flags = ["--steps", str(MESH_TRAIN_STEPS), "--ckpt-every", "100"]
        base, rec = mesh_training(counters, device, train, flags,
                                  Path(tmp) / "base")
        add(rec)
        base_params = base["state"][0]
        log_training("(a) without a mesh", base, rec, base["targs"],
                     base_params)
        for policy in ("tp", "dp"):
            m, rec = mesh_training(
                counters, device, train,
                flags + ["--mesh", MESH, "--policy", policy],
                Path(tmp) / policy)
            add(rec)
            bad = trees_equal(m["state"], base["state"])
            if m["losses"] != base["losses"] or bad:
                raise AssertionError(
                    f"(a) {policy}: the sharded run differs from the "
                    f"unsharded one: losses {m['losses']} vs "
                    f"{base['losses']}; leaves {bad[:5]}")
            wq = m["state"][0]["blocks"]["attn"]["wq"]
            log_training(f"(a) on {MESH}, policy {policy}", m, rec,
                         m["targs"], base_params)
            log(f"   (a) {policy}: {rec['launches']['bitpack_unpack'] // MESH_TRAIN_STEPS}"
                f" wire launches a step ({m['n_wire']} leaves); every loss, "
                "parameter and moment == the unsharded run's bit for bit; "
                f"a parameter block {tuple(wq.shards[0].shape)} of "
                f"{tuple(wq.shape)} a member under {wq.sharding.spec} "
                f"[{CARD['label']}]")
            del m
            gc.collect()
            torch.cuda.empty_cache()
            parts = mesh_step_parts(rec["cfg"], base["state"], device,
                                    policy)
            log(f"   (a) {policy}: one step's parts (ms, host clock between "
                "synchronisations, median of 2): " + ", ".join(
                    f"{k} {v:.2f}" for k, v in parts.items())
                + f" [{CARD['label']}]")
            gc.collect()
            torch.cuda.empty_cache()
        del base, base_params
        gc.collect()
        torch.cuda.empty_cache()
    secs["(a)"] = time.perf_counter() - t0

    # (b) serve qwen3-1.7B at full width and depth on the mesh against the
    # same serve without one: every token and every cache leaf equal
    t0 = time.perf_counter()
    sflags = ["--arch", "qwen3-1.7b", "--preset", "full", "--batch", "8",
              "--prompt-len", "64", "--gen", "32", "--device", str(device)]
    plain = serve.run_serving(serve.build_parser().parse_args(sflags))
    plain_cache = {k: v for k, v in plain["cache"].items()}
    plain_tokens, plain_tok_s = plain["tokens"], 8 * 32 / plain["decode_s"]
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    out = serve.run_serving(serve.build_parser().parse_args(
        sflags + ["--mesh", MESH]))
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    bad = [k for k in plain_cache if k != "pos" and not torch.equal(
        out["cache"][k].full(), plain_cache[k])]
    if not np.array_equal(out["tokens"], plain_tokens) or bad or \
            out["cache"]["pos"] != plain_cache["pos"]:
        raise AssertionError(f"(b) the sharded serve differs: tokens equal "
                             f"{np.array_equal(out['tokens'], plain_tokens)}"
                             f", cache leaves {bad}")
    cfg = out["cfg"]
    mesh = mesh_lib.parse_mesh(MESH, device=str(device))
    with sharding.use_mesh(mesh):
        (p_sh, _, _), _ = steps.serve_shardings(
            cfg, ShapeSpec("d", 64 + 32 + 8, 8, "decode"), mesh)
    placed = sharding.place(out["params"], p_sh)
    gather_ms = device_ms(lambda: sharding.gather(placed), args.reps)
    gather_host = ms_of(lambda: sharding.gather(placed), args.reps)
    pbytes = sum(t.numel() * t.element_size()
                 for t in leaves_of(out["params"]))
    tok_s = 8 * 32 / out["decode_s"]
    log(f"   (b) qwen3-1.7B served on {MESH} (serve_shardings, tp): "
        f"{tok_s:.1f} tok/s ({out['decode_s'] / 32 * 1e3:.3f} ms a decode "
        f"step) against {plain_tok_s:.1f} tok/s without a mesh in this run "
        f"(phase 11's 210-230); prefill {out['prefill_s']:.3f} s; every "
        f"token and every cache leaf (assembled) == the unsharded serve's; "
        f"each step gathers the parameters anew: {gather_ms:.3f} ms device "
        f"({gather_host:.3f} ms with its host time, median of {args.reps}) "
        f"for {pbytes / 1e9:.3f} GB, bound "
        f"{2 * pbytes / analysis.HBM_BW * 1e3:.3f}"
        f" ms (read and written once); peak memory {peak:.2f} GiB "
        f"[{CARD['label']}]")
    del out, placed, plain_cache
    gc.collect()
    torch.cuda.empty_cache()
    secs["(b)"] = time.perf_counter() - t0

    # (c) the MoE at full width and 1 layer: a prefill step of 8 x 128 on
    # the mesh (G = 4 DP groups) against each DP block alone
    t0 = time.perf_counter()
    mcfg = dataclasses.replace(get_arch("qwen3-moe-235b-a22b"),
                               n_layers=FAMILY_TRAIN_MOE_LAYERS)
    params = model.init_params(
        mcfg, torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, mcfg.vocab, (MESH_MOE_BATCH, MESH_MOE_SEQ)).astype(np.int32)).to(
        device)
    prefill = steps.build_prefill_step(mcfg)
    with sharding.use_mesh(mesh):
        G = sharding.dp_groups(MESH_MOE_BATCH)
        p_sh = sharding.param_shardings(params, mesh)
        b_sh = steps.batch_shardings(mcfg, ShapeSpec(
            "p", MESH_MOE_SEQ, MESH_MOE_BATCH, "prefill"), mesh)
    fn = steps.sharded_step(prefill, (p_sh, {"tokens": b_sh["tokens"]}))
    placed = sharding.place(params, p_sh)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits = fn(placed, {"tokens": tokens})
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t1
    del placed
    per = MESH_MOE_BATCH // G
    alone = torch.cat([prefill(params, {"tokens": tokens[g * per:
                                                        (g + 1) * per]})
                       for g in range(G)])
    err = float((logits.float() - alone.float()).abs().max())
    whole = prefill(params, {"tokens": tokens})
    err_whole = float((logits.float() - whole.float()).abs().max())
    if G != 4 or not torch.isfinite(logits.float()).all() or \
            err > SERVE_TOL:
        raise AssertionError(f"(c) G {G}, max |mesh - each DP block alone| "
                             f"{err} (limit {SERVE_TOL})")
    log(f"   (c) qwen3-moe-235B-A22B, {FAMILY_TRAIN_MOE_LAYERS} layer at "
        f"full width ({sum(t.numel() for t in leaves_of(params)) / 1e9:.2f}"
        f" B parameters), prefill {MESH_MOE_BATCH} x {MESH_MOE_SEQ} on "
        f"{MESH}: dp_groups {G}, {mesh_s:.3f} s; max |logits - each of the "
        f"{G} DP blocks alone (unsharded prefill)| {err:.4g} (limit "
        f"{SERVE_TOL}, phase 12's); against the unsharded prefill of the "
        f"whole batch in one group {err_whole:.4g} [{CARD['label']}]")
    del params, logits, alone, whole
    gc.collect()
    torch.cuda.empty_cache()
    secs["(c)"] = time.perf_counter() - t0

    # (d) phase 11 (b)'s run under a 4x2 mesh with a failure at step 7,
    # restarted onto a 2x2 mesh, against an uninterrupted run over the
    # batches its steps drew
    t0 = time.perf_counter()
    drawn = []
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        m, rec = mesh_training(
            counters, device, train,
            ["--steps", "12", "--ckpt-every", "5", "--fail-at", "7",
             "--mesh", ELASTIC_FROM, "--restart-mesh", ELASTIC_TO],
            Path(tmp) / "elastic", drawn)
    add(rec)
    meshes = {str(leaf.sharding.mesh) for leaf in leaves_of(m["state"][0])}
    if m["restarts"] != 1 or m["steps_done"] != 12 or len(drawn) != 15 or \
            [(s, d) for s, d, _ in m["restored"]] != [(5, True)] or \
            len(meshes) != 1 or "data=2, model=2" not in meshes.pop():
        raise AssertionError(f"(d) {m['restarts']} restarts, "
                             f"{len(drawn)} batches, restores "
                             f"{m['restored']}")
    tcfg = rec["cfg"]
    oc = adamw.AdamWConfig(lr=TRAIN_LR, compress_moments=True)
    step = steps.build_train_step(tcfg, oc, grad_compressor=collectives
                                  .make_wire_compressor(
                                      EngineConfig(device=str(device))))
    p = model.init_params(tcfg, torch.Generator(device=device).manual_seed(0),
                          device=device)
    o, replay = adamw.init(p, oc), []
    for b in drawn[:5] + drawn[8:15]:
        p, o, loss = step(p, o, b)
        replay.append(float(loss))
    got = m["losses"]
    bad = trees_equal(m["state"], (p, o))
    if got[:5] != replay[:5] or got[7:] != replay[5:] or bad:
        raise AssertionError(f"(d) losses {got} vs the uninterrupted "
                             f"{replay}; leaves {bad[:5]}")
    log(f"   (d) {ELASTIC_FROM} -> {ELASTIC_TO}: the failure at step 7, "
        f"step 5 restored straight onto the {ELASTIC_TO} mesh "
        "(restore(shardings=), device_out); the 14 losses "
        f"{', '.join(f'{x:.4f}' for x in got)} == an uninterrupted "
        "unsharded run over the batches the steps drew (0-4, 8-14), and "
        "the final state too, bit for bit; step "
        f"{float(np.median(m['step_seconds'])) * 1e3:.2f} ms (median) "
        f"[{CARD['label']}]")
    del m, p, o, drawn
    gc.collect()
    torch.cuda.empty_cache()
    secs["(d)"] = time.perf_counter() - t0
    log("   phase 15 seconds: " + ", ".join(f"{k} {v:.1f}"
                                            for k, v in secs.items()))
    log(f"   phase 15 launches: {launched}")
    return launched


# phase 16: the counts the dry-run makes on ``meta`` against the same
# programs on the card.  Peak temp bytes: the counter tracks storages on
# either device alike, so card and ``meta`` peaks must agree within
# COUNT_PEAK_TOL; the caching allocator's ``max_memory_allocated`` rounds
# every block up to 512 bytes and holds cuBLAS's workspace, so the
# dry-run's argument + temp bytes must lie within MEMORY_TOL of it
COUNT_PEAK_TOL = 0.001
MEMORY_TOL = 0.03
ROOFLINE_REPS = 5


def counted(step, args, device) -> "object":
    """``device``'s counts of ``step(*args)`` under ``count_costs``, the
    rope frequencies uploaded afresh (as the dry-run counts)."""
    from repro_torch.models import layers
    from repro_torch.roofline.count import count_costs
    layers._rope_freqs_on.cache_clear()
    with count_costs() as counter:
        out = step(*args)
        del out
    return counter.at(device)


def roofline_row(label: str, costs, model_flops: float, ms: float) -> dict:
    """Log a step's counted roofline beside its measured ms; return both."""
    from repro_torch.roofline import analysis
    roof = analysis.analyze(costs, model_flops, 1)
    log(f"   {label}: {ms:.3f} ms measured (median of {ROOFLINE_REPS}); "
        f"counted {costs.flops / 1e12:.4f} TFLOP, {costs.bytes / 1e9:.3f} "
        f"GB read and written by {costs.ops} ops: t_compute "
        f"{roof.t_compute * 1e3:.3f} ms, t_memory {roof.t_memory * 1e3:.3f} "
        f"ms, dominant {roof.dominant}, t_bound {roof.t_bound * 1e3:.3f} ms; "
        f"measured / bound {ms / (roof.t_bound * 1e3):.2f} "
        f"[{CARD['label']}]")
    return {"ms": ms, **roof.to_dict()}


def phase_roofline(args, engine) -> dict:
    """Phase 16: the port's roofline on the card (``roofline/count.py``,
    ``roofline/analysis.py``, ``launch/dryrun.py``): phase 11's serve
    decode step and its 4-layer train step without the wire, each counted
    on the card and on ``meta`` (equal counts), timed beside its counted
    roofline, the train step's memory against ``max_memory_allocated``,
    and one dry-run cell in a subprocess.  Returns the readings."""
    import gc
    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.launch import steps
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.roofline import analysis
    log("== 16 the roofline on the card: phase 11's qwen3-1.7B decode step "
        "and 4-layer train step counted on the card and on meta, each timed "
        "beside its roofline; one dry-run cell")
    device = engine.device
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}

    def same_counts(label, card, meta):
        keys = ("flops", "bytes", "coll", "ops")
        got = {k: (getattr(card, k), getattr(meta, k)) for k in keys}
        peak = card.peak / meta.peak - 1 if meta.peak else 0.0
        log(f"   {label} counts, card == meta: FLOPs {card.flops:,}, bytes "
            f"{card.bytes:,}, collectives {card.coll}, ops {card.ops}; temp "
            f"peak {card.peak:,} on the card, {meta.peak:,} on meta "
            f"({peak:+.2e}; limit {COUNT_PEAK_TOL:g})")
        bad = [k for k, (a, b) in got.items() if a != b]
        if bad or abs(peak) > COUNT_PEAK_TOL:
            raise AssertionError(f"{label}: card and meta counts differ: "
                                 f"{bad or 'peak'}")

    # (a), (b) the serve decode step: 28 layers, batch 8, a 104-position
    # cache (64 prompt + 32 generated + 8)
    cfg = get_arch("qwen3-1.7b")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init_params(cfg, gen, device=device)
    tokens = torch.randint(0, cfg.vocab, (8, 1), generator=gen,
                           device=device, dtype=torch.int32)
    serve = steps.build_serve_step(cfg)

    def decode_args(dev):
        cache = model.init_cache(cfg, 8, 104, device=dev)
        if dev == "meta":
            return (model.abstract_params(cfg), cache,
                    {"tokens": torch.empty((8, 1), dtype=torch.int32,
                                           device="meta")})
        return params, cache, {"tokens": tokens}

    card_args = decode_args(device)
    serve(*card_args)                     # warm: cuBLAS, the rope table
    card = counted(serve, card_args, device)
    same_counts("(a) decode step", card,
                counted(serve, decode_args("meta"), "meta"))
    ms = ms_of(lambda: serve(*card_args), ROOFLINE_REPS)
    step_bytes = analysis.decode_step_bytes(cfg, params, card_args[1], 8)[0]
    out["decode"] = roofline_row(
        "(b) decode step", card,
        analysis.model_flops_for(cfg, ShapeSpec("d", 104, 8, "decode")), ms)
    log(f"   the decode step's analytic bound (decode_step_bytes) "
        f"{step_bytes / analysis.HBM_BW * 1e3:.3f} ms; the eager program "
        f"moves {card.bytes / step_bytes:.1f}x its bytes")
    del params, card_args, serve
    gc.collect()
    torch.cuda.empty_cache()

    # (a)-(c) the train step: 4 layers at full width, batch 8 x 512, int8
    # moments, no gradient wire (phase 11 (b)'s step without the wire)
    tcfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    oc = adamw.AdamWConfig(lr=TRAIN_LR, compress_moments=True)
    step = steps.build_train_step(tcfg, oc)
    params = model.init_params(tcfg, gen, device=device)
    state = (params, adamw.init(params, oc))
    batch = {k: torch.randint(0, tcfg.vocab, (8, 512), generator=gen,
                              device=device, dtype=torch.int32)
             for k in ("tokens", "labels")}
    meta_state = steps.abstract_train_state(tcfg, oc)
    meta_batch = {k: torch.empty((8, 512), dtype=torch.int32, device="meta")
                  for k in batch}
    step(*state, batch)                   # warm
    sync(device)
    card = counted(step, (*state, batch), device)
    meta = counted(step, (*meta_state, meta_batch), "meta")
    same_counts("(a) train step", card, meta)
    ms = ms_of(lambda: step(*state, batch), ROOFLINE_REPS)
    out["train"] = roofline_row(
        "(b) train step", card,
        analysis.model_flops_for(tcfg, ShapeSpec("t", 512, 8, "train")), ms)
    bound, by, _, _ = analysis.train_step_bound(tcfg, params, 8, 512)
    log(f"   the train step's analytic bound (train_step_bound) {bound:.2f} "
        f"ms by {by}")
    # (c) the dry-run's argument + temp bytes against the card's peak over
    # one step (allocations outside the step's arguments subtracted)
    arg = sum(analysis.tree_bytes(t) for t in (*state, batch))
    gc.collect()
    sync(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    res = step(*state, batch)
    sync(device)
    peak = torch.cuda.max_memory_allocated(device) - before + arg
    del res
    want = arg + meta.peak
    share = peak / want - 1
    log(f"   (c) train step memory: arguments {arg / 2**30:.3f} GiB + the "
        f"dry-run's temp {meta.peak / 2**30:.3f} GiB = {want / 2**30:.3f} "
        f"GiB; max_memory_allocated over the step (less what was allocated "
        f"outside its arguments) {peak / 2**30:.3f} GiB ({share:+.2%}; "
        f"limit {MEMORY_TOL:.0%}) [{CARD['label']}]")
    if abs(share) > MEMORY_TOL:
        raise AssertionError(f"train step memory {peak} against the "
                             f"dry-run's {want}")
    out["memory"] = {"dryrun_bytes": want, "card_bytes": peak}
    del state, batch, params
    gc.collect()
    torch.cuda.empty_cache()

    # (d) one dry-run cell, as a user runs it
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        res_path = Path(tmp) / "dryrun.json"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "qwen3-1.7b", "--shape", "decode_32k", "--out", str(res_path)],
            capture_output=True, text=True, env=env, timeout=300)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"dry-run exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        cell = json.loads(res_path.read_text())[
            "qwen3-1.7b|decode_32k|single"]
    log(f"   (d) python -m repro_torch.launch.dryrun --arch qwen3-1.7b "
        f"--shape decode_32k ({secs:.1f} s, CPU counts on meta, divided "
        f"by the H100 constants): {json.dumps(cell)}")
    if cell.get("status") != "ok":
        raise AssertionError(f"dry-run cell: {cell.get('status')}")
    out["dryrun_cell"] = cell
    return out


# phase 17: the model's member program split over ``model``, one process a
# mesh member, every process on the one card and joined by gloo
SPMD_WORLD = 4
SPMD_TRAIN_MESH = ((2, 2), ("data", "model"))
SPMD_SERVE_MESH = ((1, 4), ("data", "model"))
SPMD_MOE_MESH = ((2, 2), ("data", "model"))
SPMD_TRAIN_BATCH, SPMD_TRAIN_SEQ = 8, 512
SPMD_PROMPT, SPMD_GEN = 16, 8
SPMD_MOE_BATCH, SPMD_MOE_SEQ = 8, 128
SPMD_TIMEOUT = 600
# The members' train step against the unsharded one, both in bf16 with the
# int8 wire: the members add their partial sums in bf16 (an all-reduce of
# two halves) where the unsharded matmul accumulates in float32, so the
# loss and the gradients differ by bf16 roundings.  AdamW's first step
# moves an element by at most lr * (1 + wd * |p|) (``g / |g|`` bounded by
# 1), so two correct steps from one state lie within twice that plus one
# bf16 rounding of the new value, whatever their gradients: a block laid in
# the wrong place breaks it.  The first moments are 0.1 * the gradient: a
# relative L2 error over a leaf beyond SPMD_MOMENT_TOL means a wrong
# gradient, not a rounding.
SPMD_LOSS_TOL = 2e-2
SPMD_MOMENT_TOL = 5e-2
# The MoE members run the unsharded run's routes; their own router logits
# (float32 products of bf16 hidden states) are held to the unsharded run's
# within the head logits' limit, and every route their own top-k would
# change must be a near tie within that token's difference
# (``near_tie_flips``).
SPMD_ROUTER_TOL = SERVE_TOL
GLOO = {"probe": {}}                # phase 1's reading of gloo on the card


def probe_gloo(device) -> None:
    """Phase 1's part for phases 17 and 18: gloo must take every
    collective kind and dtype of ``spmd.PROBES`` as CUDA tensors, in a
    world of this one process (the member programs hand it their tensors
    where they lie, and have no host path)."""
    from repro_torch.distributed import spmd
    device = torch.device(device)
    GLOO["probe"] = spmd.probe_backend(device, "gloo")
    refused = {k: v for k, v in GLOO["probe"].items() if v != "device"}
    log(f"   gloo on {device} (torch {torch.__version__}) takes "
        f"{len(GLOO['probe']) - len(refused)} of {len(GLOO['probe'])} "
        f"collective kinds / dtypes as {device.type} tensors")
    if refused:
        raise AssertionError(f"gloo refuses {refused} on {device}")


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 step at each element's magnitude."""
    e = torch.floor(torch.log2(x.float().abs().clamp(min=2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def _param_check(got, want, lr: float) -> tuple:
    """(max |got - want|, the elements past AdamW's two-step bound,
    elements) of one parameter block (SPMD_LOSS_TOL's comment)."""
    g, w = got.float(), want.float()
    bound = 2 * lr * (1 + 0.1 * w.abs()) + _bf16_ulp(w)
    d = (g - w).abs()
    return float(d.max()) if d.numel() else 0.0, int((d > bound).sum()), \
        d.numel()


def _moment_rel(got: dict, want: dict) -> float:
    """Relative L2 distance of two int8 moment blocks, dequantized."""
    a = (got["q"].float() * got["s"].float()).reshape(-1)
    b = (want["q"].float() * want["s"].float()).reshape(-1)
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def spmd_rank(job: dict) -> dict:
    """One member's process of phase 17 (``launch.mesh.spawn``): (a) the
    train step at (data 2, model 2), (b) greedy decode at (data 1, model
    4), (c) the MoE's prefill at (data 2, model 2), each on the member's
    blocks, each held to the unsharded run's file from the parent."""
    import gc
    import torch.distributed as dist
    from repro_torch.configs import ShapeSpec
    from repro_torch.core import plan as plan_mod, tuning
    from repro_torch.core.engine import EngineConfig
    from repro_torch.distributed import collectives, sharding, spmd
    from repro_torch.kernels import bitpack, cuda_build
    from repro_torch.launch import mesh as mesh_lib, serve, steps
    from repro_torch.models import model
    from repro_torch.optim import adamw
    if job["cache"] is not None:
        tuning.enable_compile_cache(job["cache"])
    nvcc0 = cuda_build.NVCC_RUNS
    out = {"rank": dist.get_rank()}

    # (a) one train step with the int8 wire
    mesh = mesh_lib.world_mesh(*SPMD_TRAIN_MESH, device=job["device"])
    device = mesh.member_device()
    member = spmd.Member.join(mesh, "tp")
    r = member.index
    tcfg, oc = job["tcfg"], adamw.AdamWConfig(lr=job["lr"],
                                               compress_moments=True)
    params = model.init_params(
        tcfg, torch.Generator(device=device).manual_seed(job["seed"]),
        device=device)
    batch = _spmd_batch(tcfg, job["seed"], device)
    with sharding.use_mesh(None, "tp"):
        ins, outs = steps.train_shardings(
            tcfg, ShapeSpec("t", SPMD_TRAIN_SEQ, SPMD_TRAIN_BATCH, "train"),
            mesh, oc)
    p = spmd.blocks(params, ins[0], r)
    o = spmd.blocks(adamw.init(params, oc), ins[1], r)
    b = spmd.blocks(batch, ins[2], r)
    del params
    gc.collect()
    comp = collectives.make_wire_compressor(EngineConfig(device=str(device)))
    fn = steps.member_step(steps.build_train_step(tcfg, oc,
                                                  grad_compressor=comp),
                           ins, outs, member=member)
    # the first step's wire decodes, each held to the plain bitpack body +
    # Epilogue.apply bit for bit (``check_wire``); the check's time is
    # taken out of the step's
    wire = {"checked": 0, "err": 0, "s": 0.0}
    real_dispatch = plan_mod.dispatch

    def checked_dispatch(dev, **kw):
        res = real_dispatch(dev, **kw)
        if kw.get("codec") == "bitpack" and "wire_scale" in dev:
            sync(device)
            t = time.perf_counter()
            wire["err"] += not check_wire(dev, kw, res)
            wire["checked"] += 1
            sync(device)
            wire["s"] += time.perf_counter() - t
        return res

    bitpack.LAUNCHES = 0
    plan_mod.dispatch = checked_dispatch
    try:
        sync(device)
        t0 = time.perf_counter()
        p1, o1, loss = fn(p, o, b)
        sync(device)
    finally:
        plan_mod.dispatch = real_dispatch
    out["train_first_ms"] = (time.perf_counter() - t0 - wire["s"]) * 1e3
    out["bitpack_launches"] = bitpack.LAUNCHES
    out["wire_checked"], out["wire_err"] = wire["checked"], wire["err"]
    ref = torch.load(job["train_ref"], map_location="cpu", mmap=True)
    out["loss"], out["loss_ref"] = float(loss), float(ref["loss"])
    worst, off, n = 0.0, 0, 0
    for got, want in zip(leaves_of(p1), leaves_of(
            spmd.blocks(ref["p"], ins[0], r))):
        w, k, m = _param_check(got, want.to(device), job["lr"])
        worst, off, n = max(worst, w), off + k, n + m
    out["param_max_abs"], out["param_off"], out["param_n"] = worst, off, n
    rel = []
    for mom in ("m", "v"):
        for got, want in zip(_int8_leaves(o1[mom]), _int8_leaves(
                spmd.blocks(ref[mom], ins[1][mom], r))):
            rel.append(_moment_rel(got, {k: t.to(device)
                                         for k, t in want.items()}))
        out[f"{mom}_rel_max"] = max(rel)
        rel = []
    del ref
    member.reset_transfers()
    sync(device)
    t0 = time.perf_counter()
    p2, o2, _ = fn(p1, o1, b)
    sync(device)
    out["train_ms"] = (time.perf_counter() - t0) * 1e3
    out["train_xfer"] = _transfers(member)
    out["train_blocks_gb"] = sum(t.numel() * t.element_size()
                                 for t in leaves_of(p2)) / 1e9
    del p, o, p1, o1, p2, o2, b, fn, comp
    gc.collect()
    torch.cuda.empty_cache()

    # (b) greedy decode at (data 1, model 4)
    mesh = mesh_lib.world_mesh(*SPMD_SERVE_MESH, device=job["device"])
    member = spmd.Member.join(mesh, "tp")
    r = member.index
    max_seq = SPMD_PROMPT + SPMD_GEN + 8
    params = model.init_params(
        tcfg, torch.Generator(device=device).manual_seed(job["seed"]),
        device=device)
    decode, (p_sh, c_sh, _) = serve.member_decode(tcfg, member, mesh,
                                                  SPMD_TRAIN_BATCH, max_seq)
    pm = spmd.blocks(params, p_sh, r)
    del params
    cache = spmd.blocks(model.init_cache(tcfg, SPMD_TRAIN_BATCH, max_seq,
                                         device=device), c_sh, r)
    ref = torch.load(job["serve_ref"], map_location="cpu")
    prompts = ref["prompts"].to(device)
    with torch.no_grad():
        logits, cache = serve.prefill_into_cache(tcfg, pm, cache, prompts,
                                                 decode)
        cur = ref["tokens"][:, :1].to(device)
        member.reset_transfers()
        errs, ms, same = [], [], []
        for t in range(SPMD_GEN):
            sync(device)
            t0 = time.perf_counter()
            logits, cache = decode(pm, cache, cur)
            sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            errs.append(float((logits.float() - ref["logits"][t].to(
                device).float()).abs().max()))
            # the unsharded run's tokens are fed (its greedy choices), so
            # every step's logits stay comparable
            same.append(torch.equal(torch.argmax(logits[:, -1], -1).cpu(),
                                    ref["tokens"][:, t + 1]))
            cur = ref["tokens"][:, t + 1:t + 2].to(device)
    out["decode_err"], out["decode_ms"] = max(errs), float(np.median(ms))
    out["decode_xfer"] = _transfers(member, SPMD_GEN)
    out["argmax_equal"] = sum(same)
    want = spmd.blocks({k: v for k, v in ref["cache"].items() if k != "pos"},
                       c_sh, r)
    out["cache_err"] = max(float((cache[k].float() - want[k].to(
        device).float()).abs().max()) for k in want)
    del pm, cache, ref, logits
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the MoE's prefill, experts over model = 2
    mesh = mesh_lib.world_mesh(*SPMD_MOE_MESH, device=job["device"])
    member = spmd.Member.join(mesh, "tp")
    r = member.index
    mcfg = job["mcfg"]
    params = model.init_params(
        mcfg, torch.Generator(device=device).manual_seed(job["seed"]),
        device=device)
    with sharding.use_mesh(None, "tp"):
        p_sh = sharding.param_shardings(params, mesh)
        b_sh = steps.batch_shardings(mcfg, ShapeSpec(
            "p", SPMD_MOE_SEQ, SPMD_MOE_BATCH, "prefill"), mesh)
    pm = spmd.blocks(params, p_sh, r)
    out["moe_experts"] = int(pm["blocks"]["moe"]["w_up"].shape[1])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ref = torch.load(job["moe_ref"], map_location="cpu")
    prefill = steps.member_step(
        steps.build_prefill_step(mcfg), (p_sh, {"tokens": b_sh["tokens"]}),
        sharding.NamedSharding(mesh, sharding.P()), member=member)
    tok = spmd.blocks(ref["tokens"].to(device), b_sh["tokens"], r)
    # this DP block's calls of the unsharded run (one prefill a block)
    per = len(ref["routes"]) // mesh.shape["data"]
    mine = slice(member.coord("data") * per, (member.coord("data") + 1) * per)
    member.reset_transfers()
    sync(device)
    t0 = time.perf_counter()
    with RouteTape(ref["routes"][mine]) as tape:
        logits = prefill(pm, {"tokens": tok})
    sync(device)
    out["moe_ms"] = (time.perf_counter() - t0) * 1e3
    out["moe_xfer"] = _transfers(member)
    if len(tape.calls) != per:
        raise AssertionError(f"rank {out['rank']}: {len(tape.calls)} router "
                             f"calls, the unsharded run's block made {per}")
    routes = [near_tie_flips(lg.to(device), ids.to(device), own_lg, own)
              for lg, ids, (own_lg, own) in zip(
                  ref["router"][mine], ref["routes"][mine], tape.calls)]
    out["moe_flips"] = sum(x["flips"] for x in routes)
    out["moe_routes"] = sum(x["routes"] for x in routes)
    out["moe_faults"] = sum(x["faults"] for x in routes)
    out["router_err"] = max(x["eps"] for x in routes)
    out["router_max"] = max(float(lg.abs().max())
                            for lg in ref["router"][mine])
    out["moe_err"] = float((logits.float() - ref["logits"].to(
        device).float()).abs().max())
    out["moe_finite"] = bool(torch.isfinite(logits.float()).all())
    out["nvcc"] = cuda_build.NVCC_RUNS - nvcc0
    return out


def _transfers(member, per: int = 1) -> dict:
    """The member's collective transfers since its last reset, by kind:
    (ms, GB), each divided by ``per``."""
    return {k: (member.transfer_s[k] * 1e3 / per,
                member.transfer_bytes[k] / 1e9 / per)
            for k in member.transfer_s if member.transfer_bytes[k]}


def _spmd_batch(cfg, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return {k: torch.randint(0, cfg.vocab, (SPMD_TRAIN_BATCH,
                                           SPMD_TRAIN_SEQ), generator=gen,
                             device=device, dtype=torch.int32)
            for k in ("tokens", "labels")}


def _int8_leaves(tree):
    """An int8 moment tree's ``{"q", "s"}`` leaves, in leaf order."""
    if isinstance(tree, dict) and set(tree) == {"q", "s"}:
        return [tree]
    return [x for k in sorted(tree) for x in _int8_leaves(tree[k])]


def _nccl_pair() -> str:
    """Two ranks' all-reduce of one CUDA tensor over nccl."""
    import torch.distributed as dist
    x = torch.ones(4, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    return f"rank {dist.get_rank()}: {x.tolist()}"


def phase_spmd(args, engine) -> dict:
    """Phase 17: the model's member program split over ``model``
    (``launch.steps.member_step``, ``distributed.spmd``), one process a
    member (``launch.mesh.spawn``, gloo), the 4 processes on the one card:
    a train step, greedy decode and an MoE prefill, each member's blocks
    against the unsharded run on the card.  Returns the launches."""
    import gc
    from repro_torch.configs import get_arch
    from repro_torch.core import tuning
    from repro_torch.core.engine import EngineConfig
    from repro_torch.distributed import collectives
    from repro_torch.launch import mesh as mesh_lib, serve, steps
    from repro_torch.models import model
    from repro_torch.optim import adamw
    log(f"== 17 the member program split over model, one process a member "
        f"({SPMD_WORLD} gloo processes on the one card): qwen3-1.7B trained "
        f"one step at (data 2, model 2) with the int8 wire and decoding at "
        f"(data 1, model 4), qwen3-moe-235B-A22B's prefill at (data 2, "
        f"model 2) [{CARD['label']}]")
    device = engine.device
    t_phase = time.perf_counter()
    tcfg = dataclasses.replace(get_arch("qwen3-1.7b"),
                               n_layers=TRAIN_LAYERS)
    mcfg = dataclasses.replace(get_arch("qwen3-moe-235b-a22b"),
                               n_layers=FAMILY_TRAIN_MOE_LAYERS)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        # the unsharded runs on the card, written for the members to read
        oc = adamw.AdamWConfig(lr=TRAIN_LR, compress_moments=True)
        params = model.init_params(
            tcfg, torch.Generator(device=device).manual_seed(args.seed),
            device=device)
        step = steps.build_train_step(
            tcfg, oc, grad_compressor=collectives.make_wire_compressor(
                EngineConfig(device=str(device))))
        batch = _spmd_batch(tcfg, args.seed, device)
        p1, o1, loss = step(params, adamw.init(params, oc), batch)
        sync(device)
        t0 = time.perf_counter()
        step(p1, o1, batch)
        sync(device)
        plain_train_ms = (time.perf_counter() - t0) * 1e3
        torch.save({"p": p1, "m": o1["m"], "v": o1["v"], "loss": loss},
                   tmp / "train.pt")
        del p1, o1, step
        gen = torch.Generator(device=device).manual_seed(args.seed + 2)
        prompts = torch.randint(0, tcfg.vocab, (SPMD_TRAIN_BATCH,
                                                SPMD_PROMPT), generator=gen,
                                device=device, dtype=torch.int32)
        max_seq = SPMD_PROMPT + SPMD_GEN + 8
        cache = model.init_cache(tcfg, SPMD_TRAIN_BATCH, max_seq,
                                 device=device)
        with torch.no_grad():
            logits, cache = serve.prefill_into_cache(tcfg, params, cache,
                                                     prompts)
            toks, lgs, ms = [torch.argmax(logits[:, -1:], -1).to(
                torch.int32)], [], []
            for _ in range(SPMD_GEN):
                sync(device)
                t0 = time.perf_counter()
                logits, cache = model.decode_step(tcfg, params, cache,
                                                  toks[-1])
                sync(device)
                ms.append((time.perf_counter() - t0) * 1e3)
                lgs.append(logits.cpu())
                toks.append(torch.argmax(logits[:, -1:], -1).to(
                    torch.int32))
        plain_decode_ms = float(np.median(ms))
        torch.save({"prompts": prompts.cpu(), "logits": lgs,
                    "tokens": torch.cat(toks, 1).cpu(),
                    "cache": {k: v.cpu() if isinstance(v, torch.Tensor)
                              else v for k, v in cache.items()}},
                   tmp / "serve.pt")
        del params, cache, logits
        gc.collect()
        torch.cuda.empty_cache()
        mparams = model.init_params(
            mcfg, torch.Generator(device=device).manual_seed(args.seed),
            device=device)
        tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
            0, mcfg.vocab, (SPMD_MOE_BATCH, SPMD_MOE_SEQ)).astype(
                np.int32)).to(device)
        prefill = steps.build_prefill_step(mcfg)
        dp = SPMD_MOE_MESH[0][0]
        per = SPMD_MOE_BATCH // dp      # each DP member's tokens: a group
        sync(device)
        t0 = time.perf_counter()
        with RouteTape() as tape:
            alone = torch.cat([prefill(mparams, {
                "tokens": tokens[g * per:(g + 1) * per]}) for g in range(dp)])
        sync(device)
        plain_moe_ms = (time.perf_counter() - t0) * 1e3
        torch.save({"tokens": tokens.cpu(), "logits": alone.cpu(),
                    "routes": [ids.cpu() for _, ids in tape.calls],
                    "router": [lg.cpu() for lg, _ in tape.calls]},
                   tmp / "moe.pt")
        del mparams, alone
        gc.collect()
        torch.cuda.empty_cache()
        refs_s = time.perf_counter() - t_phase

        job = {"device": "cuda" if device.type == "cuda" else str(device),
               "seed": args.seed, "lr": TRAIN_LR, "tcfg": tcfg,
               "mcfg": mcfg,
               "cache": None if tuning.compile_cache_dir() is None
               else str(tuning.compile_cache_dir()),
               "train_ref": str(tmp / "train.pt"),
               "serve_ref": str(tmp / "serve.pt"),
               "moe_ref": str(tmp / "moe.pt")}
        t0 = time.perf_counter()
        ranks = mesh_lib.spawn(spmd_rank, SPMD_WORLD, (job,),
                               device=job["device"], timeout=SPMD_TIMEOUT)
        spawn_s = time.perf_counter() - t0
    problems = []
    for res in ranks:
        r = res["rank"]
        if res["bitpack_launches"] < 1:
            problems.append(f"rank {r}: the wire launched no bitpack_unpack")
        if res["wire_err"] or res["wire_checked"] < 1:
            problems.append(f"rank {r}: {res['wire_err']} of "
                            f"{res['wire_checked']} wire decodes differ from "
                            "the plain bitpack body + Epilogue.apply")
        if res["moe_faults"] or not res["router_err"] <= SPMD_ROUTER_TOL:
            problems.append(f"rank {r}: router logits {res['router_err']:.4g} "
                            f"from the unsharded run's (limit "
                            f"{SPMD_ROUTER_TOL}), {res['moe_faults']} of "
                            f"{res['moe_flips']} changed routes no near tie")
        if res["nvcc"]:
            problems.append(f"rank {r} ran {res['nvcc']} nvcc")
        if abs(res["loss"] - res["loss_ref"]) > SPMD_LOSS_TOL:
            problems.append(f"rank {r}: loss {res['loss']} vs "
                            f"{res['loss_ref']}")
        if res["param_off"]:
            problems.append(f"rank {r}: {res['param_off']} parameter "
                            "elements past AdamW's two-step bound")
        for mom in ("m", "v"):
            if res[f"{mom}_rel_max"] > SPMD_MOMENT_TOL:
                problems.append(f"rank {r}: {mom} relative L2 "
                                f"{res[f'{mom}_rel_max']:.3g}")
        for key, tol in (("decode_err", SERVE_TOL), ("cache_err", SERVE_TOL),
                         ("moe_err", SERVE_TOL)):
            if not res[key] <= tol:
                problems.append(f"rank {r}: {key} {res[key]:.4g} (limit "
                                f"{tol})")
        if not res["moe_finite"] or \
                res["moe_experts"] != mcfg.n_experts // SPMD_MOE_MESH[0][1]:
            problems.append(f"rank {r}: MoE logits finite "
                            f"{res['moe_finite']}, {res['moe_experts']} "
                            "experts")
    worst = {k: max(res[k] for res in ranks) for k in (
        "train_first_ms", "train_ms", "param_max_abs", "m_rel_max",
        "v_rel_max", "decode_err", "decode_ms", "cache_err", "moe_err",
        "moe_ms", "train_blocks_gb", "router_err", "router_max")}
    launches = sum(res["bitpack_launches"] for res in ranks)

    def xfer(key):                    # the slowest member's, by kind
        res = max(ranks, key=lambda x: sum(ms for ms, _ in x[key].values()))
        return (f"{sum(ms for ms, _ in res[key].values()):.1f} ms in "
                f"collectives (" + ", ".join(
                    f"{k} {ms:.1f} ms for {gb:.4f} GB"
                    for k, (ms, gb) in res[key].items()) + ")")
    log(f"   (a) train step at (data 2, model 2), 4 full-width layers, "
        f"{SPMD_TRAIN_BATCH} x {SPMD_TRAIN_SEQ}, int8 wire and moments, lr "
        f"{TRAIN_LR}: {worst['train_ms']:.1f} ms a step (slowest member, "
        f"second step; first {worst['train_first_ms']:.1f} ms) against "
        f"{plain_train_ms:.1f} ms unsharded on the card in this run; "
        f"parameter blocks {worst['train_blocks_gb']:.3f} GB a member; "
        f"loss {ranks[0]['loss']:.5f} vs {ranks[0]['loss_ref']:.5f} (limit "
        f"{SPMD_LOSS_TOL}); parameters max |diff| "
        f"{worst['param_max_abs']:.3g}, "
        f"{sum(r['param_off'] for r in ranks)} of "
        f"{sum(r['param_n'] for r in ranks):,} elements past the two-step "
        f"bound; moments relative L2 m {worst['m_rel_max']:.3g}, v "
        f"{worst['v_rel_max']:.3g} (limit {SPMD_MOMENT_TOL}); "
        f"{launches} bitpack_unpack launches ("
        + ", ".join(str(r["bitpack_launches"]) for r in ranks)
        + f" by rank), the first step's "
        f"{sum(r['wire_checked'] for r in ranks)} wire decodes == the plain "
        f"bitpack body + Epilogue.apply bit for bit "
        f"({sum(r['wire_err'] for r in ranks)} differ); the second step's "
        f"{xfer('train_xfer')} [{CARD['label']}]")
    log(f"   (b) greedy decode at (data 1, model 4), batch "
        f"{SPMD_TRAIN_BATCH}, {SPMD_PROMPT}-token prompt then {SPMD_GEN} "
        f"steps: {worst['decode_ms']:.2f} ms a step (median, slowest "
        f"member) against {plain_decode_ms:.2f} ms unsharded; logits max "
        f"|diff| {worst['decode_err']:.4g}, cache blocks "
        f"{worst['cache_err']:.4g} (limit {SERVE_TOL}); argmax equal on "
        f"{min(r['argmax_equal'] for r in ranks)} of {SPMD_GEN} steps; "
        f"a step's {xfer('decode_xfer')} [{CARD['label']}]")
    log(f"   (c) qwen3-moe-235B-A22B, {mcfg.n_layers} layer, prefill "
        f"{SPMD_MOE_BATCH} x {SPMD_MOE_SEQ} at (data 2, model 2), "
        f"{ranks[0]['moe_experts']} experts a member: "
        f"{worst['moe_ms']:.1f} ms (slowest member; {xfer('moe_xfer')}) "
        f"against {plain_moe_ms:.1f} ms for the DP blocks alone unsharded; "
        f"on the unsharded run's routes: the members' router logits "
        f"{worst['router_err']:.4g} from its (limit {SPMD_ROUTER_TOL}; its "
        f"largest |logit| {worst['router_max']:.4g}), a member's own top-k "
        f"chose otherwise for {max(r['moe_flips'] for r in ranks)} of "
        f"{ranks[0]['moe_routes']} tokens, "
        f"{sum(r['moe_faults'] for r in ranks)} of them no near tie; logits "
        f"max |diff| {worst['moe_err']:.4g} (limit {SERVE_TOL}) "
        f"[{CARD['label']}]")
    log(f"   gloo was handed every collective's tensors on "
        f"{job['device']} (phase 1: it takes all "
        f"{len(GLOO['probe'])} kinds / dtypes there; no host staging in the "
        f"member program); references {refs_s:.1f} s, the {SPMD_WORLD} "
        f"processes "
        f"{spawn_s:.1f} s (start, CUDA, init, three parts)")
    from torch.multiprocessing.spawn import (ProcessExitedException,
                                             ProcessRaisedException)
    try:
        said = mesh_lib.spawn(_nccl_pair, 2, device="cuda", backend="nccl",
                              timeout=90)
        log(f"   nccl with two ranks on one card ran: {said}")
    except (ProcessRaisedException, ProcessExitedException,
            TimeoutError) as e:  # the expected refusal, printed as such
        msg = str(e).strip().splitlines()
        log(f"   nccl with two ranks on one card refused, as expected: "
            f"{type(e).__name__}: {' | '.join(m for m in msg if m)[-400:]}")
    log(f"   phase 17 seconds: {time.perf_counter() - t_phase:.1f}")
    if problems:
        raise AssertionError("phase 17: " + "; ".join(problems))
    return {"bitpack_unpack": launches}


# --------------------------------------------------------------------------
# phase 18: the decode path one process a member
# --------------------------------------------------------------------------

# 4 gloo processes on the one card, each holding only its blocks.  (a)
# phase 4's scan on (data 4); (b) phase 10's checkpoints onto (data 2,
# model 2); (c) the member reduce at 2 pods (each held by 2 data members)
# and at 4; (e)'s replay; then, each through the driver in a world of its
# own, (d) DiLoCo one process a pod and (e) phase 17 (a)'s run with a
# failure.  The steps of (d) and (e) are cut to hold the phase near 150 s.
SPMD_DECODE_WORLD = 4
SPMD_RESTORE_MESH = ((2, 2), ("data", "model"))
SPMD_PSUM_MESHES = {2: ((2, 2), ("pod", "data")), 4: ((4,), ("pod",))}
SPMD_DILOCO_STEPS = 5               # outer every 4: one sync
SPMD_FAIL_FLAGS = ["--steps", "2", "--ckpt-every", "1", "--fail-at", "1"]
SPMD_FAIL_DRAWN = (0, 2)            # the batches the steps draw (1 is lost)
SPMD_DECODE_TIMEOUT = 600


def launch_counts() -> dict:
    """Every decode kernel's launch count in this process, by kernel."""
    from repro_torch.kernels import (bitpack, cuda_rle, huffman, lzss,
                                     tdeflate)
    got = {kernel_of(c): cuda_rle.CODEC_LAUNCHES[c]
           for c in cuda_rle.CODEC_IDS}
    got.update({"bitpack_unpack": bitpack.LAUNCHES,
                "bitpack_reduce": bitpack.REDUCE_LAUNCHES,
                "tdeflate_decode": tdeflate.LAUNCHES,
                "huffman_decode": huffman.LAUNCHES,
                "lzss_decode": lzss.LAUNCHES})
    return got


def launched_since(before: dict) -> dict:
    now = launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] - before[k]}


def block_sums(out, sh, index: int, checksums) -> list:
    """The checksum of member ``index``'s block of a whole tensor under
    ``sh`` (the whole tensor where its shape cannot be placed)."""
    from repro_torch.distributed import sharding
    if sh is None or not sharding.placeable(out.shape, sh):
        return checksums(out)
    return checksums(out[sh.member_indices(out.shape)[index]].contiguous())


def fail_args(device, ckpt_dir: str) -> list:
    """``train --spmd`` flags of (e): phase 17 (a)'s run (4 full-width
    qwen3-1.7B layers, 8 x 512, int8 wire and moments) at (data 2, model
    2), with a failure after a checkpoint."""
    return ["--arch", "qwen3-1.7b", "--preset", "full", "--n-layers",
            str(TRAIN_LAYERS), "--batch", str(SPMD_TRAIN_BATCH), "--seq",
            str(SPMD_TRAIN_SEQ), "--lr", str(TRAIN_LR), "--grad-int8",
            "--compress-moments", "--mesh", "2x2", "--spmd", "--device",
            device, "--ckpt-dir", ckpt_dir, *SPMD_FAIL_FLAGS]


def spmd_decode_rank(job: dict) -> dict:
    """One member's process of phase 18 (``launch.mesh.spawn``): (a) the
    scan, (b) the restores, (c) the member reduce, each on its own blocks
    and held to the parent's checksums; and (e)'s run without the failure
    (``steps.member_step`` over the batches the failed run's steps drew),
    its final blocks' checksums."""
    import gc
    import pickle
    import torch.distributed as dist
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import ShapeSpec
    from repro_torch.core import api, plan as plan_mod, tuning
    from repro_torch.core.engine import CodagEngine, EngineConfig
    from repro_torch.core.tree import checksums
    from repro_torch.distributed import collectives, sharding, spmd
    from repro_torch.kernels import bitpack, cuda_build
    from repro_torch.launch import mesh as mesh_lib, steps, train
    from repro_torch.optim import adamw
    from repro_torch.models import model
    if job["cache"] is not None:
        tuning.enable_compile_cache(job["cache"])
    nvcc0 = cuda_build.NVCC_RUNS
    r = dist.get_rank()
    out = {"rank": r}

    # (a) phase 4's scan on (data 4): stage, decode, exchange and place
    mesh = mesh_lib.world_mesh((SPMD_DECODE_WORLD,), ("data",),
                               device=job["device"])
    device = mesh.member_device()
    engine = CodagEngine(EngineConfig(device=str(device)))
    member = spmd.member_of(mesh)
    with open(job["scan"], "rb") as f:
        cas = pickle.load(f)
    shs = [sharding.decode_out_sharding(mesh, len(ca.orig_shape))
           for ca in cas]
    parts = {"stage": 0.0, "decode": 0.0}
    real_stage, real_dispatch = (plan_mod.DecodePlan.stage_sharded,
                                 plan_mod.dispatch)

    def timed_stage(self, *a, **kw):
        sync(device)
        t = time.perf_counter()
        res = real_stage(self, *a, **kw)
        sync(device)
        parts["stage"] += time.perf_counter() - t
        return res

    def timed_dispatch(*a, **kw):
        sync(device)
        t = time.perf_counter()
        res = real_dispatch(*a, **kw)
        sync(device)
        parts["decode"] += time.perf_counter() - t
        return res

    member.reset_transfers()
    before = launch_counts()
    plan_mod.DecodePlan.stage_sharded = timed_stage
    plan_mod.dispatch = timed_dispatch
    try:
        sync(device)
        t0 = time.perf_counter()
        got = api.decompress_many(cas, engine, mesh=mesh, out_shardings=shs)
        sync(device)
        total = time.perf_counter() - t0
    finally:
        plan_mod.DecodePlan.stage_sharded = real_stage
        plan_mod.dispatch = real_dispatch
    out["scan_launches"] = launched_since(before)
    out["scan_s"] = {"total": total, **parts,
                     "exchange": member.transfer_s["all_gather"],
                     "exchange_gb": member.transfer_bytes["all_gather"] / 1e9}
    out["scan_s"]["place_and_build"] = total - sum(
        out["scan_s"][k] for k in ("stage", "decode", "exchange"))
    out["scan_bad"] = [i for i, (o, want) in enumerate(
        zip(got, job["scan_sums"][r])) if checksums(o) != want]
    out["scan_placed_gb"] = sum(o.numel() * o.element_size()
                                for o in got) / 1e9
    del got, cas
    gc.collect()
    torch.cuda.empty_cache()

    # (b) phase 10's checkpoints onto (data 2, model 2)
    mesh22 = mesh_lib.world_mesh(*SPMD_RESTORE_MESH, device=job["device"])
    out["restore"] = {}
    for name, like, shs in restore_cases(job["ckpt_layers"], mesh22):
        before = launch_counts()
        sync(device)
        t0 = time.perf_counter()
        st = ckpt.restore(str(Path(job["keep"]) / name), 1, like,
                          shardings=shs, engine=engine, device_out=True)
        sync(device)
        flat = ckpt._flatten(st)
        out["restore"][name] = {
            "s": time.perf_counter() - t0,
            "launches": launched_since(before),
            "bad": [k for k in flat
                    if checksums(flat[k]) != job["restore_sums"][name][k][r]]}
        del st, flat
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the member reduce: each member's own embedding-sized leaf
    size = PSUM_LEAF[0] * PSUM_LEAF[1]
    cfg_e = EngineConfig(device=str(device))
    out["psum"] = {}
    for n, (shape, axes) in SPMD_PSUM_MESHES.items():
        pm = mesh_lib.world_mesh(shape, axes, device=job["device"])
        pod = pm.coord("pod")
        x = torch.randn(size, generator=torch.Generator(
            device=device).manual_seed(job["seed"] + 1000 * n + pod),
            device=device)
        pmember = spmd.member_of(pm)
        pmember.reset_transfers()
        dev_ms = []

        def timed_reduce(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = real_dispatch(*a, **kw)
            end.record()
            end.synchronize()
            dev_ms.append(start.elapsed_time(end))
            return res

        before = (bitpack.REDUCE_LAUNCHES, bitpack.LAUNCHES)
        plan_mod.dispatch = timed_reduce
        try:
            sync(device)
            t0 = time.perf_counter()
            red = collectives.compressed_psum(x, "pod", mesh=pm,
                                              config=cfg_e, mean=True)
            sync(device)
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            plan_mod.dispatch = real_dispatch
        out["psum"][n] = {
            "ms": ms, "device_ms": dev_ms[0] if dev_ms else None,
            "reduce_launches": bitpack.REDUCE_LAUNCHES - before[0],
            "unpack_launches": bitpack.LAUNCHES - before[1],
            "gather_ms": pmember.transfer_s["all_gather"] * 1e3,
            "gather_gb": pmember.transfer_bytes["all_gather"] / 1e9,
            "equal": checksums(red) == job["psum_sums"][n]}
        del x, red
        gc.collect()
        torch.cuda.empty_cache()

    # (e) phase 17 (a)'s run without the failure, over the batches the
    # failed run's steps drew
    targs = train.build_parser().parse_args(fail_args(job["device"],
                                                      job["keep"]))
    cfg = train._resolve_cfg(targs)
    mesh = mesh_lib.world_mesh(*SPMD_TRAIN_MESH, device=job["device"])
    member = spmd.Member.join(mesh, targs.policy)
    loader = iter(train._build_loader(targs, cfg, device))
    drawn = [next(loader) for _ in range(max(SPMD_FAIL_DRAWN) + 1)]
    loader.close()
    oc = adamw.AdamWConfig(lr=targs.lr, compress_moments=True)
    step = steps.build_train_step(
        cfg, oc, grad_compressor=collectives.make_wire_compressor(cfg_e))
    with sharding.use_mesh(None, targs.policy):
        ins, outs = steps.train_shardings(
            cfg, ShapeSpec("train", targs.seq, targs.batch, "train"), mesh,
            oc)
    fn = steps.member_step(step, ins, outs, member=member)
    params = model.init_params(cfg, torch.Generator(
        device=device).manual_seed(0), device=device)
    p = spmd.blocks(params, ins[0], r)
    o = spmd.blocks(adamw.init(params, oc), ins[1], r)
    del params
    gc.collect()
    losses = []
    t0 = time.perf_counter()
    for i in SPMD_FAIL_DRAWN:
        p, o, loss = fn(p, o, spmd.blocks(drawn[i], ins[2], r))
        losses.append(float(loss))
    out["replay_s"] = time.perf_counter() - t0
    out["replay_losses"] = losses
    out["replay_sums"] = checksums((p, o))
    out["nvcc"] = cuda_build.NVCC_RUNS - nvcc0
    return out


def restore_cases(layers: int, mesh):
    """(directory, ``like``, shardings) of phase 10's two checkpoints
    placed on ``mesh``: the moments under ``opt_shardings``, the K/V
    weights under their parameter shardings."""
    from repro_torch.distributed import sharding
    opt_meta, params_meta = moment_like(layers)
    meta, kv_sh = kv_like(sharding, mesh)
    return (("moments", opt_meta,
             sharding.opt_shardings(opt_meta, params_meta, mesh)),
            ("weights", meta, kv_sh))


def spmd_decode_refs(args, engine, data, keep: Path, tmp: Path) -> dict:
    """What the members are held to, computed on the card in this process:
    the checksums of each member's block of phase 4's ``execute_device``
    outputs, of phase 10's unsharded restores, and of the one-process
    member reduce of the members' leaves; phase 4's blobs written for the
    members to read.  Returns the job's part of them."""
    import gc
    import pickle
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import api, plan as plan_mod
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.tree import checksums
    from repro_torch.distributed import collectives, sharding
    from repro_torch.launch import mesh as mesh_lib
    device = engine.device
    world = SPMD_DECODE_WORLD
    cas = data["cas"]
    with open(tmp / "scan.pkl", "wb") as f:
        pickle.dump(cas, f, protocol=pickle.HIGHEST_PROTOCOL)
    one = mesh_lib.make_test_mesh((world,), ("data",), device=str(device))
    refs = api.decompress_many(cas, engine, device_out=True)
    shs = [sharding.decode_out_sharding(one, o.dim()) for o in refs]
    job = {"scan": str(tmp / "scan.pkl"),
           "scan_sums": [[block_sums(o, sh, r, checksums)
                          for o, sh in zip(refs, shs)]
                         for r in range(world)],
           "scan_groups": plan_mod.DecodePlan.build(
               [b for ca in cas for b in ca.blobs]).num_dispatches,
           "scan_placeable": sum(sharding.placeable(o.shape, sh)
                                 for o, sh in zip(refs, shs)),
           "scan_gb": sum(o.numel() * o.element_size() for o in refs) / 1e9}
    del refs
    m22 = mesh_lib.make_test_mesh(*SPMD_RESTORE_MESH, device=str(device))
    job["restore_sums"] = {}
    for name, like, shs in restore_cases(args.ckpt_layers, m22):
        plain = ckpt._flatten(ckpt.restore(str(keep / name), 1, like,
                                           engine=engine, device_out=True))
        flat_sh = ckpt._flatten(shs)
        job["restore_sums"][name] = {
            k: [block_sums(v, flat_sh.get(k), r, checksums)
                for r in range(world)] for k, v in plain.items()}
        del plain
    size = PSUM_LEAF[0] * PSUM_LEAF[1]
    job["psum_sums"] = {}
    for n in SPMD_PSUM_MESHES:
        xs = torch.stack([torch.randn(size, generator=torch.Generator(
            device=device).manual_seed(args.seed + 1000 * n + p),
            device=device) for p in range(n)])
        red = collectives.compressed_psum(
            xs, "pod", mesh=mesh_lib.make_test_mesh(
                (n, 1), ("pod", "data"), device=str(device)),
            config=EngineConfig(device=str(device)), mean=True)
        job["psum_sums"][n] = checksums(red)
        del xs, red
        gc.collect()
        torch.cuda.empty_cache()
    job["keep"] = str(keep)
    return job


def phase_spmd_decode(args, engine, data=None, keep=None) -> dict:
    """Phase 18: the decode path one process a member (``launch.mesh.
    spawn``, gloo, 4 processes on the one card, each holding only its
    blocks): (a) phase 4's scan through ``decompress_many(mesh=,
    out_shardings=)``, (b) phase 10's checkpoints through
    ``restore(shardings=)``, (c) ``compressed_psum`` at 2 and 4 pods, (d)
    ``train --diloco 2 --spmd``, (e) ``train --spmd`` with a failure,
    each held to the one-process path on the card.  ``data`` and ``keep``
    are phase 4's workload and phase 10's files; without them
    (``--spmd-decode-only``) both are made here.  Returns the launches by
    kernel, over the members."""
    import gc
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import api, tuning
    from repro_torch.core.tree import checksums, leaves
    from repro_torch.data import pipeline
    from repro_torch.launch import mesh as mesh_lib, train
    log(f"== 18 the decode path one process a member ({SPMD_DECODE_WORLD} "
        f"gloo processes on the one card, each holding only its blocks): "
        f"phase 4's scan, phase 10's restores, the member reduce, DiLoCo one "
        f"process a pod, and a failure restored member by member "
        f"[{CARD['label']}]")
    device = engine.device
    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    made = None
    if data is None:
        data = main_data(args, np.random.default_rng(args.seed), api)
    if keep is None:
        made = tempfile.TemporaryDirectory(dir=ROOT / "build")
        keep = Path(made.name)
        save_phase10_files(args, keep, device, ckpt, pipeline)
    problems, launched, secs = [], {}, {}

    def count(got: dict) -> None:
        for k, v in got.items():
            launched[k] = launched.get(k, 0) + v

    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            tmp = Path(tmp)
            job = spmd_decode_refs(args, engine, data, keep, tmp)
            del data
            gc.collect()
            torch.cuda.empty_cache()
            job.update({
                "device": "cuda" if device.type == "cuda" else str(device),
                "seed": args.seed, "ckpt_layers": args.ckpt_layers,
                "cache": None if tuning.compile_cache_dir() is None
                else str(tuning.compile_cache_dir())})
            secs["references"] = time.perf_counter() - t_phase
            t0 = time.perf_counter()
            ranks = mesh_lib.spawn(spmd_decode_rank, SPMD_DECODE_WORLD,
                                   (job,), device=job["device"],
                                   timeout=SPMD_DECODE_TIMEOUT)
            secs["members"] = time.perf_counter() - t0
    finally:
        if made is not None:
            made.cleanup()
    for res in ranks:
        r = res["rank"]
        for part in ("scan_launches",):
            count(res[part])
        for v in res["restore"].values():
            count(v["launches"])
        count({"bitpack_reduce": sum(v["reduce_launches"]
                                     for v in res["psum"].values())})
        got = res["scan_launches"]
        if sum(got.values()) != job["scan_groups"] or res["scan_bad"]:
            problems.append(f"rank {r} (a): {sum(got.values())} launches for "
                            f"{job['scan_groups']} groups; outputs "
                            f"{res['scan_bad'][:5]} differ")
        for name, v in res["restore"].items():
            if v["bad"] or not v["launches"]:
                problems.append(f"rank {r} (b) {name}: leaves {v['bad'][:5]}"
                                f" differ, launches {v['launches']}")
        for n, v in res["psum"].items():
            if not v["equal"] or v["reduce_launches"] != 1 or \
                    v["unpack_launches"]:
                problems.append(f"rank {r} (c) at {n} pods: equal "
                                f"{v['equal']}, launches {v}")
        if res["nvcc"]:
            problems.append(f"rank {r} ran {res['nvcc']} nvcc")
    worst = max(ranks, key=lambda x: x["scan_s"]["total"])["scan_s"]
    log(f"   (a) phase 4's scan ({job['scan_gb']:.3f} GB decoded, "
        f"{job['scan_groups']} groups) through decompress_many(mesh=world "
        f"mesh (data {SPMD_DECODE_WORLD}), out_shardings=decode_out_sharding)"
        f": launches a member "
        + ", ".join(str(sum(x["scan_launches"].values())) for x in ranks)
        + f" (one a group); every member's block of the "
        f"{job['scan_placeable']} placeable outputs (the rest whole) equal "
        f"to phase 4's execute_device output's by checksum; slowest member "
        f"{worst['total'] * 1e3:.1f} ms: staging {worst['stage'] * 1e3:.1f},"
        f" decode {worst['decode'] * 1e3:.1f}, exchange (all-gather of the "
        f"decoded group tables) {worst['exchange'] * 1e3:.1f} ms for "
        f"{worst['exchange_gb']:.4f} GB "
        f"({worst['exchange_gb'] / max(worst['exchange'], 1e-9):.3f} GB/s), "
        f"build and placement {worst['place_and_build'] * 1e3:.1f} ms; "
        f"blocks {max(x['scan_placed_gb'] for x in ranks):.3f} GB a member "
        f"[{CARD['label']}]")
    for name in ("moments", "weights"):
        v = [x["restore"][name] for x in ranks]
        log(f"   (b) phase 10's {name} restored with shardings= onto (data "
            f"2, model 2): {max(x['s'] for x in v):.3f} s (slowest member); "
            f"every block equal to the unsharded restore's; launches by "
            f"member {[x['launches'] for x in v]} [{CARD['label']}]")
    for n in SPMD_PSUM_MESHES:
        v = [x["psum"][n] for x in ranks]
        log(f"   (c) compressed_psum of a {PSUM_LEAF[0]} x {PSUM_LEAF[1]} "
            f"float32 leaf a pod at {n} pods ({SPMD_DECODE_WORLD} members): "
            f"one codag_bitpack_reduce launch a member, equal to the "
            f"one-process reduce of the same leaves by checksum; "
            f"{max(x['ms'] for x in v):.1f} ms a call (slowest member), the "
            f"reduce's device {max(x['device_ms'] for x in v):.3f} ms, the "
            f"all-gathers {max(x['gather_ms'] for x in v):.1f} ms for "
            f"{v[0]['gather_gb']:.4f} GB [{CARD['label']}]")

    # (d) DiLoCo, one process a pod, through the driver
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        targs = train.build_parser().parse_args(
            ["--arch", "qwen3-1.7b", "--preset", "full", "--n-layers",
             str(TRAIN_LAYERS), "--batch", "8", "--seq", "512", "--steps",
             str(SPMD_DILOCO_STEPS), "--lr", str(TRAIN_LR), "--grad-int8",
             "--compress-moments", "--diloco", str(DILOCO_PODS),
             "--outer-every", str(DILOCO_OUTER_EVERY), "--spmd",
             "--ckpt-dir", str(Path(tmp) / "ckpt"), "--device",
             job["device"]])
        m = train.run_training(targs)
    secs["(d)"] = time.perf_counter() - t0
    losses, syncs = m["losses"], m["overlap"]["syncs"]
    k = max(1, len(losses) // 3)
    n_wire = sum(t[0].numel() >= 128 for t in leaves(m["states"][0][0]))
    digests = [x["sync_digests"] for x in m["ranks"]]
    if not float(np.mean(losses[-k:])) < float(np.mean(losses[:k])):
        problems.append(f"(d) loss did not fall: {losses}")
    if syncs != (SPMD_DILOCO_STEPS - 1) // DILOCO_OUTER_EVERY or \
            any(len(d) != syncs or d != digests[0] for d in digests):
        problems.append(f"(d) {syncs} syncs; the pods' anchors differ")
    for x in m["ranks"]:
        if x["launches"]["bitpack_reduce"] != n_wire * syncs or \
                x["launches"]["epilogue_unfused"]:
            problems.append(f"(d) launches {x['launches']} for {n_wire} "
                            f"leaves x {syncs} syncs")
        count({"bitpack_reduce": x["launches"]["bitpack_reduce"]})
    log(f"   (d) train --diloco {DILOCO_PODS} --spmd, one process a pod: "
        f"qwen3-1.7B at {TRAIN_LAYERS} layers, 8 x 512 a pod, int8 wires and "
        f"moments, outer every {DILOCO_OUTER_EVERY}, {SPMD_DILOCO_STEPS} "
        f"steps: losses {', '.join(f'{v:.4f}' for v in losses)}; {syncs} "
        f"syncs, the pods' anchors equal after each (checksums); "
        f"codag_bitpack_reduce launches a pod "
        f"{[x['launches']['bitpack_reduce'] for x in m['ranks']]} for "
        f"{n_wire} leaves a sync, 0 epilogues unfused; overlap "
        f"{json.dumps(m['overlap'])}; step "
        f"{float(np.median(m['step_seconds'])) * 1e3:.1f} ms (median, rank "
        f"0's host clock); {secs['(d)']:.1f} s [{CARD['label']}]")
    del m
    gc.collect()

    # (e) phase 17 (a)'s run with a failure, restored member by member
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        m = train.run_training(train.build_parser().parse_args(
            fail_args(job["device"], str(Path(tmp) / "ckpt"))))
    secs["(e)"] = time.perf_counter() - t0
    sums = [checksums(tuple(tree_to(s, device) for s in state))
            for state in m["states"]]
    bad = [r for r, (s, x) in enumerate(zip(sums, sorted(
        ranks, key=lambda x: x["rank"]))) if s != x["replay_sums"]]
    rep = ranks[0]["replay_losses"]
    if m["restarts"] != 1 or bad or m["losses"] != rep:
        problems.append(f"(e) {m['restarts']} restarts; members {bad} differ "
                        f"from the run without the failure; losses "
                        f"{m['losses']} against {rep}")
    log(f"   (e) train --spmd at (data 2, model 2), phase 17 (a)'s run "
        f"{' '.join(SPMD_FAIL_FLAGS)}: {m['restarts']} restart (every member "
        f"restored its step-1 blocks with restore(shardings=) onto the same "
        f"world), losses {', '.join(f'{v:.5f}' for v in m['losses'])}; every "
        f"member's final blocks equal (checksums) to the run without the "
        f"failure over the batches its steps drew "
        f"({', '.join(map(str, SPMD_FAIL_DRAWN))}; "
        f"{max(x['replay_s'] for x in ranks):.1f} s); {secs['(e)']:.1f} s "
        f"[{CARD['label']}]")
    del m
    gc.collect()
    torch.cuda.empty_cache()
    log("   phase 18 seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items())
        + f"; total {time.perf_counter() - t_phase:.1f}")
    log(f"   phase 18 launches over the members: {launched}")
    if problems:
        raise AssertionError("phase 18: " + "; ".join(problems))
    return launched


# --------------------------------------------------------------------------
# phase 19: the examples
# --------------------------------------------------------------------------

# In this process, on the card: (path, argv, the check lines its reference
# prints, the kernels it must launch).  The registry gate runs through its
# ``main``; the others as ``python <path>`` would.
EXAMPLE_RUNS = (
    ("examples/torch_quickstart.py", [],
     ("engine [CODAG  warp-unit, all-thread  ] decode OK",
      "engine [RAPIDS block-unit, single-thr.] decode OK",
      "hand-written CUDA kernel (backend='cuda') decode OK"),
     (kernel_of("rle_v1"), kernel_of("rle_v2"), "tdeflate_decode",
      "scalar_decode")),
    ("examples/torch_compressed_checkpoint.py", [],
     ("restore bit-exact OK", "leaves codec-compressed, mean stored ratio"),
     (kernel_of("rle_v2"),)),
    ("examples/torch_streaming_restore.py", [],
     ("(over budget: True)", "12 backend fetches",
      "12 released + 0 evicted, 0 B resident at the end",
      "ms of I/O hidden behind decode"),
     (kernel_of("rle_v2"),)),
    ("scripts/torch_check_registry.py", ["--device", "cuda"],
     ("registry complete: ['bitpack', 'dbp', 'huffman', 'lzss', 'rle_v1', "
      "'rle_v2', 'tdeflate']",),
     tuple(kernel_of(c) for c in ("rle_v1", "rle_v2", "dbp", "bitpack",
                                  "tdeflate", "huffman", "lzss"))),
)
# In subprocesses (the veneers over the drivers), on phase 2's compile
# cache: (path, flags).  The driver's full runs are phase 11's; 8 train
# steps keep this one cheap.
EXAMPLE_SUBPROCESSES = (
    ("examples/torch_serve_lm.py", []),
    ("examples/torch_train_lm.py", ["--steps", "8"]),
)
EXAMPLES_TIMEOUT = 300


def run_in_process(path: Path, argv: list, counters: dict) -> tuple:
    """Run an example (or the registry gate's ``main``) in this process,
    its standard output captured, with every launch count set to 0 just
    before and read just after; returns its lines, its launches by kernel
    and its seconds."""
    for c in counters.values():
        c.reset()
    out = io.StringIO()
    saved = sys.argv
    t0 = time.perf_counter()
    try:
        sys.argv = [str(path), *argv]
        with contextlib.redirect_stdout(out):
            if path.parent.name == "scripts":
                rc = runpy.run_path(str(path))["main"](argv)
                if rc != 0:
                    raise AssertionError(f"{path.name} returned {rc}")
            else:
                runpy.run_path(str(path), run_name="__main__")
        torch.cuda.synchronize()
    except BaseException:
        log(out.getvalue())
        raise
    finally:
        sys.argv = saved
    seconds = time.perf_counter() - t0
    launched = {k: c.read() for k, c in counters.items() if c.read()}
    return out.getvalue().splitlines(), launched, seconds


def phase_examples(counters: dict, src: Path) -> dict:
    """The port's examples and its registry gate on the card; returns the
    in-process runs' launches by kernel, summed."""
    from repro_torch.core import tuning
    log("== 19 the examples: examples/torch_{quickstart,compressed_"
        "checkpoint,streaming_restore}.py and scripts/torch_check_registry."
        "py --device cuda in this process; examples/torch_serve_lm.py and "
        "torch_train_lm.py --steps 8 as subprocesses, started first "
        f"[{CARD['label']}]")
    cache = tuning.compile_cache_dir()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(src)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs, ends = [], {}
    for rel, flags in EXAMPLE_SUBPROCESSES:
        cmd = [sys.executable, str(ROOT / rel), *flags]
        if cache is not None:
            cmd += ["--compile-cache", str(cache)]
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        proc = subprocess.Popen(cmd, stdout=out, stderr=err, text=True,
                                env=env, cwd=ROOT)
        # a thread a subprocess takes the time its process ends
        ended = threading.Thread(target=lambda p=proc, r=rel: (
            p.wait(), ends.__setitem__(r, time.perf_counter())), daemon=True)
        ended.start()
        procs.append((rel, time.perf_counter(), proc, out, err))
    total: dict = {}
    try:
        for rel, argv, checks, must in EXAMPLE_RUNS:
            lines, launched, seconds = run_in_process(ROOT / rel, argv,
                                                      counters)
            for line in lines:
                log(f"   | {line}")
            last = "registry complete" if "scripts" in rel else "OK"
            problems = []
            if not lines or not lines[-1].startswith(last):
                problems.append(f"last line {lines[-1:]!r}, not {last!r}")
            problems += [f"no line {want!r}" for want in checks
                         if not any(want in line for line in lines)]
            problems += [f"{k} not launched" for k in must
                         if launched.get(k, 0) < 1]
            if problems:
                raise AssertionError(f"phase 19, {rel}: "
                                     + "; ".join(problems))
            log(f"   {' '.join([rel, *argv])}: {seconds:.1f} s, launches "
                f"{json.dumps(launched)}")
            for k, n in launched.items():
                total[k] = total.get(k, 0) + n
        for rel, t0, proc, out, err in procs:
            proc.wait(timeout=EXAMPLES_TIMEOUT)
            seconds = ends.get(rel, time.perf_counter()) - t0
            out.seek(0)
            err.seek(0)
            lines = out.read().splitlines()
            for line in lines:
                log(f"   | {line}")
            if proc.returncode != 0 or not lines or lines[-1] != "OK":
                raise AssertionError(
                    f"phase 19, {rel}: exit {proc.returncode}, last line "
                    f"{lines[-1:]!r}\n{err.read()[-3000:]}")
            log(f"   {rel}: exit 0 in {seconds:.1f} s (its own process, "
                "its launches not counted here)")
    finally:
        for _, _, proc, out, err in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()
    log(f"   phase 19 in-process launches, summed: {json.dumps(total)} "
        f"[{CARD['label']}]")
    return total


# phase 20: the per-blob decode entry points on the card
OPS_KERNEL_BACKEND = "cuda"        # the hand-written kernels
OPS_BACKENDS = ("cuda", "torch", "oracle", "scalar")
VEC_DIR = ROOT / "tests" / "vectors"


def golden_vectors(codec: str) -> list:
    """(record, input array) of every committed golden vector of
    ``codec``."""
    import base64
    payload = json.loads((VEC_DIR / f"{codec}.json").read_text())
    return [(v, np.frombuffer(base64.b64decode(v["data_b64"]),
                              np.dtype(v["dtype"])).reshape(v["shape"]))
            for v in payload["vectors"]]


def ops_reference(args, data, engine) -> dict:
    """Phase 4's plan parts and decoded group tables for ``--ops-only``
    (the full run keeps phase 4's own)."""
    from repro_torch.core import api, plan as plan_mod, transfers
    t0 = time.perf_counter()
    plan = plan_mod.DecodePlan.build([b for ca in data["cas"]
                                      for b in ca.blobs])
    build_ms = (time.perf_counter() - t0) * 1e3
    stage_ms, _, tables, dec_ms = staged_decode(plan_mod, transfers, plan,
                                                engine, args.reps)
    del plan
    e2e = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        out = api.decompress_many(data["cas"], engine, device_out=True)
        torch.cuda.synchronize()
        e2e.append((time.perf_counter() - t0) * 1e3)
        del out
    return dict(tables=tables, build_ms=build_ms, stage_ms=stage_ms,
                decode_ms=dec_ms, e2e_ms=float(np.median(e2e)))


def phase_ops(args, engine, counters: dict, data=None) -> dict:
    """Phase 20: the reference's conformance API on the card.  (a) every
    golden vector of every codec through ``ops.decode_blob`` on each of
    ``OPS_BACKENDS``, equal to its input; (b) one blob of each of phase 4's
    groups through ``decode_table_device``, equal to its rows of phase 4's
    ``execute_device`` table, ``format.reassemble_device`` of it equal to
    ``decode_blob``'s host array, and the group's ``concat_blobs`` table
    through ``decode_table_device`` as one launch, equal to phase 4's
    table; (c) each blob's host ms of ``decode_blob`` and device ms of
    ``decode_table_device`` beside phase 4's ``decompress_many`` parts.
    ``data`` is phase 4's workload with its tables (``ops_ref``); without
    it (``--ops-only``) both are made here.  Returns the launches of (a)
    and (b) by kernel."""
    from repro_torch.core import api, encoders as enc, format as fmt
    from repro_torch.core import plan as plan_mod, registry
    from repro_torch.kernels import ops
    label = CARD["label"]
    log("== 20 the per-blob decode entry points: ops.decode_blob, "
        "decode_table, decode_table_device and format.reassemble_device "
        f"on the card [{label}]")
    device = engine.device
    if data is None:
        data = main_data(args, np.random.default_rng(args.seed), api)
        data["ops_ref"] = ops_reference(args, data, engine)
    ref = data["ops_ref"]
    for c in counters.values():
        c.reset()

    def launched() -> int:
        return sum(c.read() for c in counters.values())

    # (a) the golden vectors on every backend
    t0 = time.perf_counter()
    bad, n_vec, by_backend = [], 0, {b: 0.0 for b in OPS_BACKENDS}
    for codec in registry.names():
        for v, arr in golden_vectors(codec):
            blob = enc.compress(arr, codec, v["chunk_bytes"], bits=v["bits"])
            n_vec += 1
            for backend in OPS_BACKENDS:
                t1 = time.perf_counter()
                got = ops.decode_blob(blob, backend, device=device)
                by_backend[backend] += time.perf_counter() - t1
                if not (got.dtype == arr.dtype and got.shape == arr.shape
                        and np.array_equal(got, arr)):
                    bad.append(f"{codec}/{v['name']}/{backend}")
    if bad:
        raise AssertionError(f"phase 20 (a): differ from their inputs: "
                             f"{bad}")
    golden = {k: c.read() for k, c in counters.items() if c.read()}
    log(f"   (a) {n_vec} golden vectors of {len(registry.names())} codecs "
        f"through ops.decode_blob on {', '.join(OPS_BACKENDS)}: every one "
        f"equal to its input in {time.perf_counter() - t0:.1f} s ("
        + ", ".join(f"{b} {t:.2f} s" for b, t in by_backend.items())
        + f"); launches {json.dumps(golden)} [{label}]")

    # (b) phase 4's blobs, one a group, and each group's fused table
    flat = [b for ca in data["cas"] for b in ca.blobs]
    plan = plan_mod.DecodePlan.build(flat)
    if len(plan.groups) != len(ref["tables"]):
        raise AssertionError("phase 20 (b): phase 4's tables are not its "
                             "plan's groups")
    picked, concat_ms = [], 0.0
    for g, table in zip(plan.groups, ref["tables"]):
        blob = flat[g.blob_ids[0]]
        raw = ops.decode_table_device(blob, OPS_KERNEL_BACKEND,
                                      device=device)
        rows = table[:blob.num_chunks]
        host = ops.decode_blob(blob, OPS_KERNEL_BACKEND, device=device)
        placed = fmt.reassemble_device(blob, raw).cpu().numpy()
        t1 = time.perf_counter()
        merged = fmt.concat_blobs([flat[i] for i in g.blob_ids])
        concat_ms += (time.perf_counter() - t1) * 1e3
        before = launched()
        fused = ops.decode_table_device(merged, OPS_KERNEL_BACKEND,
                                        device=device)
        n_fused = launched() - before
        problems = []
        if not bits_equal(raw.cpu(), rows):
            problems.append("decode_table_device differs from phase 4's "
                            "rows")
        if not (placed.dtype == host.dtype and placed.shape == host.shape
                and np.array_equal(placed, host)):
            problems.append("reassemble_device differs from decode_blob")
        if not bits_equal(fused.cpu(), table):
            problems.append("the fused table differs from phase 4's")
        if OPS_KERNEL_BACKEND == "cuda" and n_fused != 1:
            problems.append(f"the fused table took {n_fused} launches")
        if problems:
            raise AssertionError(f"phase 20 (b), group {g.key}: "
                                 + "; ".join(problems))
        picked.append((g, blob))
        del raw, fused, merged
    ops_launches = {k: c.read() for k, c in counters.items()}
    log(f"   (b) {len(picked)} groups: one blob each through "
        "decode_table_device equal to its rows of phase 4's execute_device "
        "table and reassemble_device equal to decode_blob's host array; "
        f"{len(picked)} concat_blobs tables ({plan.num_chunks} chunks, "
        f"merged in {concat_ms:.2f} ms on the host) each one launch equal "
        f"to phase 4's table [{label}]")
    log(f"   phase 20 launches (a) and (b): "
        f"{json.dumps({k: v for k, v in ops_launches.items() if v})} "
        f"[{label}]")

    # (c) times of the per-blob path, beside phase 4's decompress_many
    host_sum = dev_sum = 0.0
    for g, blob in picked:
        host = []
        for _ in range(args.reps):
            t1 = time.perf_counter()
            ops.decode_blob(blob, OPS_KERNEL_BACKEND, device=device)
            host.append((time.perf_counter() - t1) * 1e3)
        d_ms = device_ms(lambda: ops.decode_table_device(
            blob, OPS_KERNEL_BACKEND, device=device), args.reps)
        h_ms = float(np.median(host))
        host_sum += h_ms
        dev_sum += d_ms
        log(f"   (c) group {g.key}: a blob of {blob.num_chunks} chunks, "
            f"{blob.total_elems * blob.width / 2**20:.2f} MiB decoded: "
            f"decode_blob {h_ms:.3f} ms (host clock), decode_table_device "
            f"{d_ms:.3f} ms (device: staging copy and kernel), median of "
            f"{args.reps} [{label}]")
    log(f"   (c) the {len(picked)} blobs: decode_blob {host_sum:.3f} ms, "
        f"decode_table_device {dev_sum:.3f} ms in all; phase 4's "
        f"decompress_many of all {len(flat)} blobs: end to end "
        f"{ref['e2e_ms']:.2f} ms, of one call DecodePlan.build "
        f"{ref['build_ms']:.2f} ms, stage {ref['stage_ms']:.2f} ms, staged "
        f"decode {ref['decode_ms']:.3f} ms [{label}]")
    return ops_launches


def tree_to(tree, device):
    """A tree of CPU tensors moved to ``device`` (dicts and tuples)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def leaves_of(tree):
    from repro_torch.core.tree import leaves
    return list(leaves(tree))


def save_phase10_files(args, keep: Path, device, ckpt, pipeline) -> None:
    """Phase 10's two checkpoints and spilled corpus, for ``--sharded-only``
    (the full run keeps phase 10's own)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    t0 = time.perf_counter()
    ckpt.save(str(keep / "moments"), 1,
              moment_state(gen, args.ckpt_layers, device), codec="bitpack")
    state = {name: torch.randn(k, n, generator=gen, device=device).to(
        torch.bfloat16) * 0.02 for name, k, n in QWEN3_PROJECTIONS
        if name in ("k", "v")}
    ckpt.save(str(keep / "weights"), 1, state, codec="tdeflate")
    toks = pipeline.synthetic_corpus(args.corpus_tokens, VOCAB,
                                     seed=args.seed)
    pipeline.CompressedTokenStore.build(toks, VOCAB,
                                        spill_dir=str(keep / "shards"))
    log(f"   phase 10's checkpoints and corpus made in "
        f"{time.perf_counter() - t0:.1f} s")


PHASE_S: dict = {}                 # phase -> its wall seconds


def timed(phase: int, fn, *args, **kw):
    """``fn(*args, **kw)`` as phase ``phase``: its wall seconds logged on a
    line of their own and kept for the script's summary."""
    t0 = time.perf_counter()
    got = fn(*args, **kw)
    PHASE_S[phase] = time.perf_counter() - t0
    log(f"   phase {phase}: {PHASE_S[phase]:.1f} s of wall clock "
        f"[{CARD['label']}]")
    return got


class Counter:
    """A kernel's launch count on the main path: reset, then read (a
    module's ``attr``, or its ``CODEC_LAUNCHES[codec]``)."""

    def __init__(self, module, codec=None, attr="LAUNCHES"):
        self.module, self.codec, self.attr = module, codec, attr

    def reset(self) -> None:
        if self.codec is None:
            setattr(self.module, self.attr, 0)
        else:
            self.module.CODEC_LAUNCHES[self.codec] = 0

    def read(self) -> int:
        if self.codec is None:
            return getattr(self.module, self.attr)
        return self.module.CODEC_LAUNCHES[self.codec]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gib", type=float, default=1.0,
                    help="uncompressed GiB decoded by the main-path call")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--text-mib", type=float, default=8.0,
                    help="MiB of distinct log text encoded with tdeflate")
    ap.add_argument("--td-chunks", type=int, default=2048,
                    help="least chunks in the main path's tdeflate group")
    ap.add_argument("--td-plain-rows", type=int, default=256,
                    help="rows of the tdeflate group the plain version "
                    "decodes (its lockstep body steps every row a token at "
                    "a time, streams.lockstep)")
    ap.add_argument("--ent-chunks", type=int, default=1024,
                    help="least chunks in each of the main path's huffman "
                    "and lzss groups")
    ap.add_argument("--lz-plain-rows", type=int, default=64,
                    help="rows of the lzss group the plain version decodes "
                    "(its token parse steps every row a token at a time, "
                    "streams.lockstep)")
    ap.add_argument("--q-layers", type=int, default=4,
                    help="qwen3-1.7B layers of the quantized-weight path")
    ap.add_argument("--scalar-plain-elems", type=int, default=2048,
                    help="elements of each row the plain scalar bodies "
                    "decode in phase 8 (one step of torch ops an element)")
    ap.add_argument("--scalar-reps", type=int, default=None,
                    help="timing repetitions of phase 8's single-thread "
                    "pass (default: --reps)")
    ap.add_argument("--ckpt-layers", type=int, default=4,
                    help="qwen3-1.7B layers of AdamW int8 moments in phase "
                    "10's bitpack checkpoint")
    ap.add_argument("--corpus-tokens", type=int, default=1 << 24,
                    help="tokens of phase 10's rle_v2 corpus (one epoch "
                    "through the loader in each mode)")
    ap.add_argument("--families-only", action="store_true",
                    help="run phases 1, 2 and 12 alone (the other model "
                    "families), with no result line")
    ap.add_argument("--collectives-only", action="store_true",
                    help="run phases 1, 2 and 13 alone (the collective "
                    "plane and DiLoCo), with no result line")
    ap.add_argument("--sharded-only", action="store_true",
                    help="run phases 1, 2 and 14 alone (mesh placement), "
                    "with no result line")
    ap.add_argument("--mesh-only", action="store_true",
                    help="run phases 1, 2 and 15 alone (the model's steps "
                    "under a mesh), with no result line")
    ap.add_argument("--roofline-only", action="store_true",
                    help="run phases 1, 2 and 16 alone (the roofline on "
                    "the card), with no result line")
    ap.add_argument("--spmd-only", action="store_true",
                    help="run phases 1, 2 and 17 alone (the member program "
                    "split over model, one process a member), with no "
                    "result line")
    ap.add_argument("--spmd-decode-only", action="store_true",
                    help="run phases 1, 2 and 18 alone (the decode path one "
                    "process a member), with no result line")
    ap.add_argument("--examples-only", action="store_true",
                    help="run phases 1, 2 and 19 alone (the examples and "
                    "the registry gate), with no result line")
    ap.add_argument("--ops-only", action="store_true",
                    help="run phases 1, 2 and 20 alone (the per-blob decode "
                    "entry points; phase 4's data made for it), with no "
                    "result line")
    ap.add_argument("--stage-only", action="store_true",
                    help="only time DecodePlan.build and stage by part on "
                    "phase 4's workload (cold, then warm), and stop")
    ap.add_argument("--src", type=Path, default=None,
                    help="with --stage-only: the directory holding another "
                    "checkout's repro_torch package, to time its staging "
                    "alike")
    args = ap.parse_args()
    if args.src is not None and not args.stage_only:
        ap.error("--src needs --stage-only")
    if args.scalar_reps is None:
        args.scalar_reps = args.reps
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    src = (args.src or ROOT / "src").resolve()
    if not all((src / "repro_torch" / "csrc" / f).exists()
               for f, _ in SOURCES.values()):
        print(f"FAIL: the port's sources are not under {src}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.core import api, encoders as enc, format as fmt
    from repro_torch.core import plan as plan_mod, registry, transfers
    from repro_torch.core import tuning
    from repro_torch.core.engine import CodagEngine
    from repro_torch.kernels import (bitpack, cuda_build, cuda_rle, harness,
                                     huffman, lzss, ops, scalar, tdeflate)
    from repro_torch.kernels import dequant_matmul as dq

    rng = np.random.default_rng(args.seed)

    def phase_one():
        phase_env()
        if not args.stage_only:
            probe_gloo(torch.device("cuda", torch.cuda.current_device()))

    timed(1, phase_one)
    if args.stage_only:
        log(f"== 4 DecodePlan.build and stage by part only, package under "
            f"{src}")
        data = main_data(args, rng, api)
        device = torch.device("cuda", torch.cuda.current_device())
        torch.zeros(1, device=device)     # the CUDA context, before timing
        torch.cuda.synchronize()
        build_stage_parts(plan_mod, fmt, ops, transfers,
                          [b for ca in data["cas"] for b in ca.blobs], device)
        return 0
    from repro_torch.core import server, store
    timed(2, phase_build, cuda_build, tuning,
          [cuda_rle.LIB, *cuda_rle.LIB_EPI.values(), bitpack.LIB,
           tdeflate.LIB, huffman.LIB, lzss.LIB, dq.LIB, scalar.LIB],
          [dq.WGMMA, scalar.TDEFLATE, scalar.LZSS, scalar.HUFFMAN,
           scalar.BITPACK, bitpack.REDUCE], src)
    engine = CodagEngine()
    errs = {k: 0 for k in KERNELS}
    counters = {kernel_of(c): Counter(cuda_rle, c) for c in cuda_rle.CODEC_IDS}
    counters["bitpack_unpack"] = Counter(bitpack)
    counters["tdeflate_decode"] = Counter(tdeflate)
    counters["huffman_decode"] = Counter(huffman)
    counters["lzss_decode"] = Counter(lzss)
    counters["dequant_matmul"] = Counter(dq)
    # phase 19's runs count these two as well
    example_counters = dict(counters, scalar_decode=Counter(scalar),
                            bitpack_reduce=Counter(
                                bitpack, attr="REDUCE_LAUNCHES"))
    if args.examples_only:
        launched = timed(19, phase_examples, example_counters, src)
        log(f"phase 19 alone, launches: {json.dumps(launched)}")
        return 0
    if args.ops_only:
        launched = timed(20, phase_ops, args, engine, example_counters)
        log(f"phase 20 alone, launches: {json.dumps(launched)}")
        return 0
    if args.families_only:
        launched = phase_families(args, engine, counters)
        log(f"phase 12 alone, launches: {json.dumps(launched)}")
        return 0
    if args.collectives_only:
        reduce_row, launched = phase_collectives(args, engine, counters)
        log(f"phase 13 alone: {json.dumps(reduce_row)}")
        return 0
    if args.sharded_only:
        launched = phase_sharded(args, engine, counters)
        log(f"phase 14 alone, launches: {json.dumps(launched)}")
        return 0
    if args.mesh_only:
        launched = phase_mesh(args, engine, counters)
        log(f"phase 15 alone, launches: {json.dumps(launched)}")
        return 0
    if args.roofline_only:
        phase_roofline(args, engine)
        return 0
    if args.spmd_only:
        launched = phase_spmd(args, engine)
        log(f"phase 17 alone, launches: {json.dumps(launched)}")
        return 0
    if args.spmd_decode_only:
        launched = phase_spmd_decode(args, engine)
        log(f"phase 18 alone, launches: {json.dumps(launched)}")
        return 0
    def phase_three():
        phase_kernel_vs_plain(rng, fmt, enc, registry, harness, errs,
                              engine.device, counters)
        phase_dequant_vs_plain(rng, dq, errs, engine.device)

    timed(3, phase_three)
    launches, per, data = timed(
        4, phase_main, args, rng, api, plan_mod, transfers, registry,
        harness, {"tdeflate": tdeflate, "lzss": lzss, "cuda_rle": cuda_rle,
                  "fmt": fmt, "ops": ops}, counters, engine, errs)
    timed(5, phase_epilogue, args, api, fmt, registry, harness, engine, data)
    launches["dequant_matmul"] = timed(
        6, phase_quantized, args, rng, dq, harness, transfers, counters,
        engine, errs, per)["dequant_matmul"]
    timed(7, phase_service, args, api, fmt, ops, transfers, server, store,
          engine, data, counters)
    launches["scalar_decode"] = timed(
        8, phase_ablation, args, data, engine, scalar, registry, harness,
        transfers, errs, per)
    del data["plan"]              # its staged tables; phase 14 stages anew
    torch.cuda.empty_cache()
    timed(9, phase_tuning, args, tuning, api, fmt, registry, engine)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as keep:
        consumer = timed(10, phase_consumers, args, engine, counters, server,
                         store, Path(keep))
        model_launches = timed(11, phase_model, args, engine, counters)
        family = timed(12, phase_families, args, engine, counters)
        reduce_row, dil = timed(13, phase_collectives, args, engine,
                                counters)
        placed = timed(14, phase_sharded, args, engine, counters, data,
                       Path(keep))
        meshed = timed(15, phase_mesh, args, engine, counters)
        timed(16, phase_roofline, args, engine)
        split = timed(17, phase_spmd, args, engine)
        # phase 4's blobs (host memory only) and phase 10's files kept
        decoded = timed(18, phase_spmd_decode, args, engine, data,
                        Path(keep))
    examples = timed(19, phase_examples, example_counters, src)
    # phase 4's blobs and its decoded group tables (host memory) kept
    by_ops = timed(20, phase_ops, args, engine, example_counters, data)
    del data
    log("   phase seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(PHASE_S.items()))
        + f" [{CARD['label']}]")
    log(f"   the script: {time.perf_counter() - T_START:.1f} s of wall "
        f"clock, imports included [{CARD['label']}]")
    log("== 21 kernels")
    kernels = []
    for name in KERNELS:
        source, replaces = SOURCES.get(
            name, ("two_phase_rle.cu", "src/repro/kernels/harness.py:359"))
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": per[name]["ms"],
            "device_ms": per[name]["device_ms"],
            "plain_ms": per[name]["plain_ms"],
            "plain_rows": per[name]["plain_rows"],
            "bound_ms": per[name]["bound_ms"],
            "bound_by": per[name].get("bound_by", "bytes"),
            "library_ms": per[name].get("library_ms"),
            **{k: per[name][k] for k in ("sweep_ms", "library_sweep_ms",
                                         "weight_decode_host_ms",
                                         "weight_decode_device_ms",
                                         "all_thread_device_ms",
                                         "plain_elems")
               if k in per[name]},
        })
        if name in consumer:       # phase 10's launches
            kernels[-1]["consumer_launches"] = consumer[name]
        if name in model_launches:  # phase 11's
            kernels[-1]["model_launches"] = model_launches[name]
        if name in family:          # phase 12's
            kernels[-1]["family_launches"] = family[name]
        if name in dil:             # phase 13's
            kernels[-1]["diloco_launches"] = dil[name]
        if name in placed:          # phase 14's
            kernels[-1]["sharded_launches"] = placed[name]
        if name in meshed:          # phase 15's
            kernels[-1]["mesh_launches"] = meshed[name]
        if name in split:           # phase 17's, summed over the members
            kernels[-1]["spmd_launches"] = split[name]
        if name in decoded:         # phase 18's, summed over the members
            kernels[-1]["spmd_decode_launches"] = decoded[name]
        kernels[-1]["examples_launches"] = examples.get(name, 0)  # 19's
        exact = name != "dequant_matmul"    # held to TOL in phases 3 and 6
        if exact:                   # phase 20's, every decode kernel
            kernels[-1]["ops_launches"] = by_ops.get(name, 0)
            if kernels[-1]["ops_launches"] < 1:
                raise AssertionError(f"{name}: not launched by phase 20's "
                                     "per-blob entry points")
        if kernels[-1]["launches"] < 1 or (exact and errs[name]):
            raise AssertionError(f"{name}: not launched on the main path, or "
                                 "differs from its plain version")
    reduce_row["spmd_decode_launches"] = decoded.get("bitpack_reduce", 0)
    reduce_row["examples_launches"] = examples.get("bitpack_reduce", 0)
    kernels.append(reduce_row)      # bitpack's second entry, phase 13's
    for name in [kernel_of(c) for c in ("rle_v1", "rle_v2", "dbp", "bitpack",
                                        "tdeflate", "huffman", "lzss")] + [
            "bitpack_reduce"]:
        if decoded.get(name, 0) < 1:
            raise AssertionError(f"{name}: not launched by phase 18's "
                                 "members")
    for name in (kernel_of("rle_v2"), "bitpack_unpack", "bitpack_reduce"):
        if dil.get(name, 0) < 1:
            raise AssertionError(f"{name}: not launched by phase 13's "
                                 "DiLoCo run")
    for name in (kernel_of("rle_v2"), "bitpack_unpack"):
        if meshed.get(name, 0) < 1:
            raise AssertionError(f"{name}: not launched by phase 15's "
                                 "steps under a mesh")
    if split.get("bitpack_unpack", 0) < 1:
        raise AssertionError("bitpack_unpack: not launched by phase 17's "
                             "members")
    if reduce_row["max_abs_err"] != 0:
        raise AssertionError("bitpack_reduce differs from its plain version")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
