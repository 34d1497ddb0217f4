#!/usr/bin/env python3
"""Drive the PyTorch port (rejit_tpu_torch) on one CUDA card and check it.

Run from the repository root, on a machine with an NVIDIA card and nvcc:

    python3 chip_smoke.py            # everything (what the chip check runs)
    python3 chip_smoke.py --quick    # build, checks and main paths; no timing
    python3 chip_smoke.py --times b1|scan|tile|count [--port-root DIR]
        # one kernel's rows only, for the port in DIR (default: this
        # checkout), for a before column: b1, the split route's
        # dfa_phase1/dfa_phase3 (DIR may hold an older checkout whose
        # kernels took int32 views); scan, scan1d at 10 M and 256 Mi
        # (events, then the profiler) and the classrun and classlit
        # paths' device_time_s at 10 MB and 256 MiB; tile, schain_fused's
        # tile instance (the `_schain_fused_tile` hook) in L (L+I) and
        # count modes on the four log-search workloads, the line-long
        # case, config 3's tables and the two no-die cases (Q = 3 and 42)
        # at 10 MB and 256 MiB, on the log text of this script's own
        # checkout; count, match_all_count of the benchmark cells'
        # patterns at 10 MB and 256 MiB staged, its wall with torch's
        # profiler off and recording, and its device_time_s

It builds the port's CUDA kernels from the sources in the checkout (one nvcc
per source, all started together), then:

1. prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, the kernel build time and what ptxas reports;
2. holds every kernel against its plain PyTorch version on the same CUDA
   tensors, bit for bit: dfa_phase1 and dfa_phase3 for 8 pattern sets on
   200 KB texts with a block where no thread of a word pattern dies (at
   n = len and n inside the first block, with the dead state and with
   none, whose outputs must not differ; phase 3 also with posbase, some
   blocks at a base of n): 6 small sets, the 250-word alternation (its
   94 KB table in shared memory) and a 1000-word one (past the limit,
   the read-only-cache instance), then on the 10 MB main text and the
   250-word set on 10 MB of letters; schain_fused in its L, L+I and count
   modes, with the FF tile skip on and off, with the solo and a neutral
   seed (G included), at n = P, P-3, a tile edge, 1 and 0, for 10 pattern
   sets (Q = 2..242, every sweep width W = 2..32) on dense and sparse
   200 KB texts, in both kernel instances where Q <= 32 (the sweep and the
   tile instance) and the tile instance above, at fused blocks K = 8, 24
   and 64 beside the default 32, and on the 10 MB dense and sparse texts
   (W = 8 and 32, several tiles a chunk) at n = P, P-3 and, per mode from
   the card's own geometry, a tile edge inside a chunk, a chunk edge and
   a segment edge of the sweep instance, and a tile edge inside a
   segment, a grid-range edge inside a tile and a segment edge of the tile
   instance; the sparse texts must take the skip; literal_spans at caps 0,
   2, 4 and 16 for sets of 1, 3, 9 and 15 literals of 1 to 128 bytes and
   a set of 1-, 3-, 4-, 5- and 8-byte
   literals, at n = P, P-3, a row edge, a block edge, 1 and 0, and for the
   12 keywords on the main text; scan1d in both directions on random
   (the whole int32 range), monotone and constant int32, on small values
   with INT_MIN and INT_MAX planted anywhere, in the first tile and in
   the last, at 1, 31, around one and two of its tiles, 1,000,003, the
   main path's length and 256 Mi, on offset views x[1:] (4 bytes off 16)
   and 200 times in a row at one tile, a few tiles and 10 M, with one
   counted call a wrapper call; schain_fused with emit_f (L and L+I
   modes: L, I, G, and F on boundaries 0..n, F past n apart) on the same
   matrix of fused cases, from the begin context and from another start
   state at byte 0, and
   dfa_phase3 with such a start state on the 8 sets;
3. runs the main path, `Pattern(r"\\b\\w+ing\\b").match_all_arrays(text)`
   on the 10 MB config-3 corpus, with the launch counters set to 0 just
   before and read just after: it must launch schain_fused and neither
   split kernel, and give the spans of Python `re`, of the port's CPU run
   and of match_all_count; the count mode (count_device_staged, and
   match_all_count of an overlap-free pattern on the DFA engine) and a
   staged corpus (`stage`) on every entry point are checked on the same
   text;
   then the log-search workloads (`log_phase`, the tile instance's,
   Q = 37..40): over `make_log_corpus(size, seed=1)` at 10 MB and
   256 MiB, a level alternation, an access-log request line, a UUID and
   the mariomka/regex-benchmark Email / URI / IP list (L+I mode) each take
   the fused route's tile instance with one schain_fused call a
   match_all_arrays call; at 10 MB their spans (and pattern ids) equal
   Python `re` and the port's CPU run, and the kernel equals its plain
   version at the tile instance's tile, range and segment edges, as it
   is on the two worst cases that --times tile times (a line-long
   pattern over the log text, and threads that never die at Q = 42 over
   letters and spaces); outside --quick the kernel's device ms (events; L or L+I, and count mode) and
   the match_all_arrays walls, host bytes and staged, with the card's
   name and power limit, at both sizes;
4. drives the split kernels on their paths, each with its own counts: a
   250-word alternation (tables too large for the fused kernel),
   `Config(schain_fused='off')` on the main text and on a sparse text (the
   fast-forward route, dfa_phase3 with posbase), each launching both split
   kernels; and the 3-pattern tokenizer on the fused route; each against
   `re` or the CPU run;
5. runs config 1 (`packet` over the 10 MiB `make_corpus(seed=0,
   needle=b"packet", density=0.002)`, the program bench.py times): the
   literal engine's bitmask route, no kernel launched, spans equal to
   `re`, the other entry points and a staged corpus agreeing;
6. runs the literal_spans path: 12 overlap-free keywords on the main text,
   which must launch the kernel again after the cap grows and give the
   spans of `re`, and the same words as a 12-pattern list, whose tokens
   must equal the CPU run's; then the literal_count kernel
   (`literal_count_phase`): held bit-equal to its plain version on
   `literal_sets`' sets over `literal_text` (one, two and four state
   words, several launches a set), a `(?i)` set and a 160-byte literal,
   at n = P, P - 3, 3 segments, 1, 0, -5 and past P, at the text's
   address and 5 bytes past it; and its path, match_all_count of the
   literal cell's `foo|bar|baz` on portbench's corpus staged at 10 MB
   (one launch and nothing else, equal to `bytes.count`), and outside
   --quick at 256 MiB and 2e9 bytes with the kernel's and the plain
   version's device ms beside the bound, and the staged call's wall;
7. runs the scan1d paths, `\\b\\w{3,50}\\b` (classrun, one launch a call)
   and `\\b[a-z]{2,60}ing\\b` (classlit, two), each against the port's DFA
   route and `re`;
8. runs the stream path (`stream_phase`): first holds schain_fused with
   emit_f against its plain version at the shapes that path gives it on
   the 256 MiB config-3 text (an interior 8 MiB chunk, the last chunk
   padded past its boundary n, and the ladder's 1 MiB, shifted and doubled
   windows, each from the stream's neutral seed and its first_start);
   then config 3 (256 MiB,
   `match_all_stream` in 8 MiB chunks with a state directory) on the fused
   route, killed by its progress callback after 5 chunks and resumed,
   equal to `match_all_arrays`, one schain_fused (emit_f) call a chunk;
   the 250-word set on 256 MiB of letters with a word planted across every
   chunk edge on the split route, killed and resumed, equal to
   `match_all_arrays` over pieces cut after spaces, one dfa_phase1 and one
   dfa_phase3 call a chunk, its peak device memory; `match_first` /
   `match_anywhere` on 256 MiB by the first-window ladder (at most 4
   schain_fused calls; a staged corpus uploads nothing more), a pattern
   with no match walking the ladder to the end, `match_full_stream` on
   both routes; no chunk retried; outside --quick the stream walls (with
   and without a state directory), emit_f against L mode and the early
   exit against the full scan;
9. runs the gather probe (`gather_probe_phase`), the last TPU kernel's
   counterpart: gather_probe held bit-equal to its plain version in both
   modes (n = 0 and 1, U = 1 and 8, QS = 8, 32 and 128, one block and one
   a SM, and at the script's defaults on every SM), its SASS opcode counts
   (cuobjdump), then the probe's own path (`probes.gather_probe.measure`,
   serial and select at ITERS 4096, U 8, QS 32, on one block and on every
   SM's resident blocks) with its launch count, the ratio of the lookup
   and select-row rates, the Q where one lookup costs a Q-term select
   chain, and (outside --quick) the lookup rate with conflict-free banks;
10. runs the DFA-blowup fallback chain (`posnfa_phase`): `(a|b)*a(a|b){14}`
   under the default Config must take the posnfa engine with the JAX
   package's warning and match 10 MB of `default_rng(7).choice(b"aabbx")`
   (five 2 MiB chunks of the exact sweep) equal to `re`, its 64 KB prefix
   equal to the port's CPU run and to the oracle; match_first, match_full,
   match_anywhere, tokenize, match_all_count, a staged corpus and the
   stream (killed after 2 chunks and resumed, and its first/anywhere/full
   forms) agree; `(a|b)*a(a|b){45}` (W = 3, K = 128) on the same text; no
   CUDA kernel of the port is launched (torch ops); the oracle route (a
   forced engine and a `posnfa='off'` blowup) on 2 KB equal to `re`;
   outside --quick the walls, per-chunk device ms, peak memory and the
   byte bound;
11. runs regex-dna (`replace_phase`; samples/regexdna.py's steps) at the
   Benchmarks Game's size, 50,000,000 bases (~50.8 MB of FASTA): the
   native helpers must load (built with g++ at first use); the header
   strip (`replace` of `(>[^\\n]*\\n)|\\n`, a DFA) must launch schain_fused
   and nothing else, the nine `(?i)` variant counts on the staged result
   no kernel, the 11-code IUB `replace_each` (22 single-byte literals)
   literal_spans and nothing else; the three outputs equal Python `re`
   byte for byte, a 1 MB prefix equal to the port's CPU run and to
   `Config(selection='python')` on the card; replace_first and split
   (with and without maxsplit) on the 10 MB config-3 text equal to `re`;
   outside --quick each step's wall (median of 3) and its last_stats
   device / selection split, and the strip with the Python selection;
   then device-side selection (`select_phase`): `\\b\\w{3,50}\\b` (classrun)
   and `\\w+\\s` (DFA, overlapping candidates) over config 3 at 10 MB and
   256 MiB (10 MB only under --quick), from host bytes and staged, with
   the default threshold (the native greedy walk) and
   `Config(device_select_threshold=0)` (pointer doubling): equal arrays,
   equal to `re` at 10 MB, each with its candidates, cap bucket, rounds,
   peak device memory and (outside --quick) wall;
12. runs the mesh= path (`mesh_phase`) on 8 shards of the card and on 1:
   config 3 (256 MiB) on the sharded fused route (8 schain_fused calls
   with emit_f a call, and nothing else) and under schain_fused='off'
   (8 dfa_phase1 and 8 dfa_phase3), config 5 (`packet` over 1 GiB of
   `make_corpus(seed=4, density=0.002)`: the literal route's spans
   through the API, no kernel, and its psum count, one literal_count a
   shard and nothing else; `sharded_l_arrays` on its DFA
   tables, fused), config 4's tokenizer and the 250-word set (10 MB, split)
   and a sparse text (the FF skip), each equal to the single-device call,
   configs 3 and 5 to `re` and config 5's count to `bytes.count`; the
   kernels held against their plain versions on calls the path made
   (recorded: shard inputs, first_start, neutral seed; schain_fused with
   the skip on and off); the two-process gloo worker (4 shards a rank on
   cuda:0) and a one-rank NCCL group (8 shards), each printing MULTIPROC
   OK; outside --quick the walls of the single-device call against D = 1
   and D = 8 (median of 3);
13. counts the DFA routes' launches under each route setting (`route_phase`,
   config 3's first MiB, each call equal to `re`): the default config and
   `schain_fused='on'` with `matmul='on'` launch schain_fused alone,
   `matmul='on'` no kernel, `schain='on'`, `pallas='on'` and
   `pallas='off'` the split kernels alone (the fused route stands aside,
   as in the JAX package), `match_all_stream` under each the same kernels
   (the split chunk engine under `matmul='on'`), and `mesh=` the same
   launches with `matmul='on'` as without it;
14. runs the matmul engine (`matmul_phase`; engine/matmul.py, bf16 torch
   products): L/I bit-equal to the split route and the fused kernel on
   config 3's and the tokenizer's tables over the 10 MB main text and on
   a 40-word alternation (Q = 179, two slabs) over 1 MiB, no kernel
   launched, and `Config(matmul='on')` spans equal to `re`;
15. runs the on-card gate in this process
   (`rejit_tpu_torch/tools/verify_cuda.py --subset 1`): the DFA routes'
   L/I bit-equal at 1 MiB and all 140 cases of the conformance corpus
   under automatic choice, `engine='dfa'` with `schain_fused` on and off,
   `matmul='on'` and `mesh=` (8 shards);
16. runs the tools and samples on the card: jrep (`jrep_phase`) over a
   tree of 64 files of 1 MiB of config-3 text and small ^ / $ files,
   batched, per file, -c, --count-matches, --stream and anchors, each
   equal to Python `re`, and over the port's sources equal to its CPU
   run; profile_match at 10 MiB in a process of its own, whose Chrome
   trace must parse and name the schain_fused kernels; basic equal to its
   CPU run and regexdna at 50,000,000 bases equal to the counts and
   lengths `replace_phase` held against `re`;
17. times the kernels, their plain versions, the library calls, the split
   route's stages and the entry points' walls (host bytes and staged
   corpus) with CUDA events and the host clock, on the 10 MB text and on
   a 256 MiB text from the same generator, and config 1 at 10 MiB and
   256 MiB; schain_fused in both instances; the split route (time_b1:
   dfa_phase1/3, plain versions, suffix scan, l_arrays_device and its
   peak memory, the live work b1_work counts and the bounds from it) on
   config 3 at both sizes, the 250-word alternation at 10 MB (with its
   match_all_arrays wall) and config 3's table on 10 MB of letters; the
   matmul engine's L/I device time and peak memory beside the fused and
   split routes at both sizes, with the match_all_arrays wall under
   `matmul='on'`; the classrun and classlit paths' device_time_s at both
   sizes; last,
   schain_fused per launch, the posnfa engine's device operations on one
   2 MiB chunk, the matmul engine's device time by kernel at 10 MB, and
   scan1d at 10 M and 256 Mi (torch.profiler; scan1d must show one kernel
   a call, also under --quick).

A `device_time_s` here is `last_stats.device_time_s`: the time between
two CUDA events around the engine's kernels (from its first kernel, after
the text's upload, to its last, before the call's host read; summed over
chunks on the stream calls), so no dispatch, upload or sync
(utils/stats.py:MatchStats).

Every result is a JSON line; the `{"kernels": [...]}` line and the card's
nvidia-smi line come just before the last line, which is
`{"ok": true, "device": {...}}`. Any failed check raises: the script then
exits non-zero and prints no result. Without a CUDA device it exits 1.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# 32-bit lane instructions per second: the data sheet's 67 TFLOP/s float32
# outside the tensor cores, an FMA counted once (132 SMs x 128 lanes). The
# integer instructions of a step issue on those lanes; taking all 128 per SM
# gives the least time, as a bound must.
PEAK_LANE_OPS_PER_S = 67e12 / 2
# ALU instructions of one automaton step: index multiply-add, accept mask
# and -1, compare, two selects, state shift (the table load is a memory
# instruction and is not counted).
ALU_OPS_PER_STEP = 7
MAIN_PATTERN = rb"\b\w+ing\b"
TOKENIZER = [rb"\w+", rb"\s+", rb"[^\w\s]+"]
COUNT_PATTERN = rb"matching"   # overlap-free: MatchAllCount in count mode
# BASELINE config 1, the program bench.py times: one literal over
# make_corpus(size, seed=0, needle=b"packet", density=0.002).
CONFIG1_PATTERN = rb"packet"
CONFIG1_SIZE = 10 * 1024 * 1024
# Twelve overlap-free keywords (more than the bitmask route's 8 literals):
# the literal_spans kernel's path, as one alternation and as a tokenizer.
KEYWORDS = (b"packet", b"stream", b"vector", b"filter", b"kernel", b"device",
            b"branch", b"offset", b"brown", b"state", b"gamma", b"delta")
# The elementwise engines' paths on the card (scan1d launches per call).
B3_PATTERNS = {"classrun": (rb"\b\w{3,50}\b", 1),
               "classlit": (rb"\b[a-z]{2,60}ing\b", 2)}
K = 32
SOURCES = {
    "dfa_phase1": "rejit_tpu_torch/kernels/csrc/dfa_phases.cu",
    "dfa_phase3": "rejit_tpu_torch/kernels/csrc/dfa_phases.cu",
    "schain_fused": "rejit_tpu_torch/kernels/csrc/schain_fused.cu",
    "literal_spans": "rejit_tpu_torch/kernels/csrc/literal_spans.cu",
    "scan1d": "rejit_tpu_torch/kernels/csrc/scan1d.cu",
    "schain_fused_emit_f": "rejit_tpu_torch/kernels/csrc/schain_fused.cu",
    "gather_probe": "rejit_tpu_torch/kernels/csrc/gather_probe.cu",
    "literal_count": "rejit_tpu_torch/kernels/csrc/literal_count.cu",
}
REPLACES = {
    "dfa_phase1": "rejit_tpu/kernels/dfa_pallas.py:95",
    "dfa_phase3": "rejit_tpu/kernels/dfa_pallas.py:175",
    "schain_fused": "rejit_tpu/kernels/schain_pallas.py:1070",
    "literal_spans": "rejit_tpu/kernels/extract_pallas.py:118",
    "scan1d": "rejit_tpu/kernels/scan1d.py:94",
    "schain_fused_emit_f": "rejit_tpu/kernels/schain_pallas.py:1070 (emit_f)",
    "gather_probe": "bench/gather_probe.py:46",
    "literal_count": "rejit_tpu/kernels/literal.py:50 literal_count_device "
                     "(XLA-fused, no Pallas kernel)",
}
DEV = "cuda"
WORD_CHARS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz  ", np.uint8)
ENTRY_POINTS = ("match_full", "match_anywhere", "match_first", "match_all",
                "tokenize", "match_all_count")
STREAM_CHUNK = 8 << 20   # chunk_bytes of the stream phase
STREAM_SIZE = 256 << 20
# The JAX package's posnfa workload (bench/harness.py config3_posnfa_blowup):
# a DFA blowup (~2^15 states) over default_rng(7).choice(b"aabbx") bytes;
# Q = 32 positions (one word, K = 64). Beside it the W = 3 case (Q ~ 100,
# K = 128) of tests/unit/test_posnfa.py.
POSNFA_PATTERN = rb"(a|b)*a(a|b){14}"
POSNFA_W3_PATTERN = rb"(a|b)*a(a|b){45}"
POSNFA_SIZE = 10_000_000
POSNFA_CHECK = 1 << 16   # the prefix held against the CPU run and the oracle
POSNFA_CHUNK = 2 << 20   # Config.posnfa_chunk_bytes: the stream's chunks
# The gather probe: the JAX script's defaults, and the shorter chains the
# kernel is held against its plain version on.
PROBE_DEFAULTS = dict(iters=4096, u=8, qs=32)
PROBE_CHECK_ITERS = 37
# 32-bit shared-memory loads an H100 SM issues a clock (128 B/clk): a
# quarter of its 128 integer lanes, so a quarter of the lane rate.
SMEM_LOADS_PER_S = PEAK_LANE_OPS_PER_S / 4
# regex-dna (samples/regexdna.py) at the Benchmarks Game's input size
# (fasta N = 5,000,000: 50,000,000 bases, ~50.8 MB): strip the headers and
# newlines, count nine variants, replace the 11 IUB codes.
DNA_BASES = 50_000_000
DNA_CHECK = 1 << 20   # the prefix held against the CPU and 'python' runs
DNA_STRIP = rb"(>[^\n]*\n)|\n"
DNA_VARIANTS = (
    "agggtaaa|tttaccct", "[cgt]gggtaaa|tttaccc[acg]",
    "a[act]ggtaaa|tttacc[agt]t", "ag[act]gtaaa|tttac[agt]ct",
    "agg[act]taaa|ttta[agt]cct", "aggg[acg]aaa|ttt[cgt]ccct",
    "agggt[cgt]aa|tt[acg]accct", "agggta[cgt]a|t[acg]taccct",
    "agggtaa[cgt]|[acg]ttaccct",
)
DNA_IUB = (("B", b"(c|g|t)"), ("D", b"(a|g|t)"), ("H", b"(a|c|t)"),
           ("K", b"(g|t)"), ("M", b"(a|c)"), ("N", b"(a|c|g|t)"),
           ("R", b"(a|g)"), ("S", b"(c|g)"), ("V", b"(a|c|g)"),
           ("W", b"(a|t)"), ("Y", b"(c|t)"))
# Device against host selection: a class run (not a run partition) and a
# DFA whose candidates overlap (every word byte starts one), over config 3.
SELECT_PATTERNS = {"classrun": rb"\b\w{3,50}\b", "dfa": rb"\w+\s"}
SELECT_SIZES = (10_000_000, 256 << 20)
# The one kernel each select case's engine launches a call.
SELECT_KERNEL = {"classrun": "scan1d", "dfa": "schain_fused"}
# The mesh= path (`mesh_phase`): D shards on one card, and the single
# device. BASELINE config 5 (`bench/harness.py:617-660`): `packet` over
# make_corpus(seed=4, density=0.002), at 1 GiB (int32 positions, one call);
# config 3 at 256 MiB; config 4 (the tokenizer) and the 250-word set at
# 10 MB.
MESH_D = 8
CONFIG5_SIZE = 1 << 30
MESH_CONFIG3_SIZE = 256 << 20
MESH_SMALL_SIZE = 10_000_000
MESH_WORKER_TIMEOUT_S = 300
# The DFA routes' launch counts, the matmul engine, the tools and samples.
ROUTE_SIZE = 1 << 20       # config 3's first MiB: the route counts' text
ROUTE_CHUNK = 256 << 10    # the stream's chunk in the route counts
MATMUL_WORDS = (3, 40)     # word_set(default_rng(3), 40): Q = 179, C = 27
MATMUL_WORDS_SIZE = 1 << 20
JREP_FILES = 64            # files of JREP_FILE_BYTES of config-3 text
JREP_FILE_BYTES = 1 << 20
JREP_LINE_WORDS = 12       # words a line of the jrep tree's files
PROFILE_SIZE_MB = 10
# Log search (the tile instance's workloads, Q = 37..40): four patterns over
# `make_log_corpus(size, seed=LOG_SEED)` at 10 MB and 256 MiB. "d" is the
# public mariomka/regex-benchmark's Email, URI and IP patterns as one list
# (its `(?:` groups written as `(`: the parser takes no `(?:`), run in L+I
# mode; `LOG_RE` holds the `re` forms the spans are held against.
LOG_SEED = 1
LOG_SIZES = (10_000_000, 256 << 20)
LOG_PATTERNS = {
    "a": rb"\b(ERROR|WARN|WARNING|FATAL|CRITICAL|SEVERE|PANIC|ALERT|EMERG)\b",
    "b": rb'"(GET|POST|PUT|DELETE|HEAD|OPTIONS|PATCH) [^ ]* HTTP/1\.[01]" '
         rb"[0-9]{3}",
    "c": rb"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}",
    "d": [rb"[\w\.+-]+@[\w\.-]+\.[\w\.-]+",
          rb"[\w]+://[^/\s?#]+[^\s?#]+(\?[^\s#]*)?(#[^\s]*)?",
          rb"((25[0-5]|2[0-4][0-9]|[01]?[0-9][0-9])\.){3}"
          rb"(25[0-5]|2[0-4][0-9]|[01]?[0-9][0-9])"],
}
LOG_RE = {k: (b"|".join(b"(?P<p%d>%s)" % (i, x.replace(b"(", b"(?:"))
                        for i, x in enumerate(v))
              if isinstance(v, list) else v)
          for k, v in LOG_PATTERNS.items()}
# The tile instance's worst case: threads that never die (every byte of
# words_text is in [a-z ]), through the tile hook (Q = 3), and on a table
# the wrapper gives the tile instance (Q = 42: all 40 states of the cycle
# live through every piece).
NODIE_PATTERN = rb"[a-z ]*q"
NODIE_WIDE_PATTERN = rb"([a-z ]{40})*q"
# Threads that live to the end of a log line (Q = 38): each line holding
# an alert level, over the log text.
LINES_PATTERN = (rb"[^\n]*\b(ERROR|WARN|WARNING|FATAL|CRITICAL|SEVERE|PANIC"
                 rb"|ALERT|EMERG)\b")


START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase line also carries the seconds since start."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def wall_s(fn, reps: int, warm: bool = True) -> dict:
    """Host-clock walls of fn() (after a warm-up call): median, min, max."""
    if warm:
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return {"median_s": float(np.median(walls)), "min_s": min(walls),
            "max_s": max(walls), "calls": reps}


def max_abs_err(a, b) -> int:
    if isinstance(a, (tuple, list)):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        check(a is None and b is None, "one output is missing")
        return 0
    check(a.shape == b.shape and a.dtype == b.dtype, "shape/dtype differ")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def padded(text: bytes, dev, grain: int = K) -> torch.Tensor:
    n = len(text)
    P = max(1, -(-n // grain)) * grain
    pad = np.zeros(P, dtype=np.uint8)
    pad[:n] = np.frombuffer(text, dtype=np.uint8)
    return torch.from_numpy(pad).to(dev)


def dfa_tables(rt, pats):
    """The pattern's DFA tables on the card (the DFA engine forced: literal
    and class-run patterns otherwise take engines without tables; a state
    limit above the default 4096 for the 1000-word alternation, whose
    subset construction passes it before minimisation)."""
    return rt.Pattern(pats, rt.Config(engine="dfa", max_dfa_states=16384),
                      device=DEV).ct


def word_set(rng, count: int) -> list:
    """`count` random lower-case words of 5-8 letters, sorted (fewer when
    some repeat): an alternation of them has tables too large for the fused
    kernel."""
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    return sorted({rng.choice(letters, size=int(rng.integers(5, 9))).tobytes()
                   for _ in range(count)})


def words_text(size: int) -> bytes:
    """Letters and spaces (WORD_CHARS): the 250-word alternation's text."""
    return np.random.default_rng(13).choice(WORD_CHARS, size=size).tobytes()


def time_split_sets(rt, words, reps: int) -> list:
    """[(label, time_b1 result)] on the split route's other 10 MB inputs:
    the 250-word alternation on letters and spaces (Q = 871, the tables
    the fused kernel does not take), and config 3's table on letters only,
    where the threads of the states inside a word never die (early exit's
    worst case on that table)."""
    letters = np.frombuffer(WORD_CHARS.tobytes().strip(), np.uint8)
    only_letters = np.random.default_rng(17).choice(
        letters, size=10_000_000).tobytes()
    return [
        ("250-word alternation", time_b1(
            rt, b"|".join(words), words_text(10_000_000), reps, 1,
            wall_reps=5)),
        ("config 3 table on letters", time_b1(
            rt, MAIN_PATTERN, only_letters, reps, 2)),
    ]


def b1_times(rt, reps: int) -> None:
    """--times b1: the split route's rows only (time_b1) for the imported
    port: config 3 at 10 MB and 256 MiB and time_split_sets, one line
    each."""
    from rejit_tpu_torch.utils.corpus import make_corpus

    for label, size, r in (("10MB", 10_000_000, reps),
                           ("256MiB", 256 << 20, max(1, reps // 4))):
        text = make_corpus(size, seed=2, needle=b"matching", density=0.01)
        emit({"phase": "times_b1", "set": "config 3", "label": label,
              **time_b1(rt, MAIN_PATTERN, text, r, 1,
                        wall_reps=max(2, r // 2))})
        del text
    for label, res in time_split_sets(rt, word_set(np.random.default_rng(7),
                                                   250), reps // 2):
        emit({"phase": "times_b1", "set": label, "label": "10MB", **res})


def split_kernels_vs_plain(rt, pats, text: bytes, dev, seed: int,
                           full: bool = True) -> dict:
    """Max |kernel - plain| of dfa_phase1/3 on the same CUDA tensors, at
    n = len(text) and, with `full`, at n inside the first block, with the
    tables' dead state and with none (threads then run to their block
    ends), and phase 3 on gathered blocks with posbase (some at a base of
    n); the kernels' change when they stop at the dead state (must be 0);
    whether they kept the table in shared memory. With `full`, blocks 5
    and 6 become letters, where the threads of word patterns never die."""
    from dataclasses import replace

    from rejit_tpu_torch.engine import pipeline
    from rejit_tpu_torch.kernels import dfa_cuda as dc

    if full:
        text = text[:5 * K] + b"a" * (2 * K) + text[7 * K:]
    ct = dfa_tables(rt, pats)
    t = padded(text, dev)
    err = {"dfa_phase1": 0, "dfa_phase3": 0}
    runs = [(len(text), ct)]
    if full:
        runs += [(K - 3, ct), (len(text), replace(ct, dead=-1))]
    outs = []
    for n, tabs in runs:
        summ = dc.phase1(tabs, t, n, K)
        err["dfa_phase1"] = max(err["dfa_phase1"], max_abs_err(
            summ, dc.phase1_plain(tabs, t, n, K)))
        suf = pipeline.suffix_scan(summ, pipeline.eot_seed(tabs, n))
        li = dc.phase3(tabs, suf, t, n, K)
        err["dfa_phase3"] = max(err["dfa_phase3"], max_abs_err(
            li, dc.phase3_plain(tabs, suf, t, n, K)))
        outs.append((summ, li))
        # Boundary 0 from another start state (a stream chunk's byte 0).
        fs = (int(tabs.plan.start_by_ctx[0]) + 1) % tabs.n_states
        err["dfa_phase3_first_start"] = max(
            err.get("dfa_phase3_first_start", 0), max_abs_err(
                dc.phase3(tabs, suf, t, n, K, first_start=fs),
                dc.phase3_plain(tabs, suf, t, n, K, first_start=fs)))
    dead_stop = max_abs_err(outs[0], outs[-1])
    # Gathered blocks as the fast-forward route sends them, plus blocks at
    # a base of n (their bytes run past the text's end).
    n = len(text)
    suf = pipeline.suffix_scan(outs[0][0], pipeline.eot_seed(ct, n))
    rng = np.random.default_rng(seed)
    nb = t.shape[0] // K
    pick = np.sort(rng.choice(nb, size=max(1, nb // 3), replace=False))
    idx = torch.as_tensor(pick, device=dev)
    posbase = (idx * K).to(torch.int32)
    posbase[torch.as_tensor(rng.random(len(pick)) < 0.1, device=dev)] = n
    sub = tuple(x.index_select(0, idx) for x in suf)
    err["dfa_phase3"] = max(err["dfa_phase3"], max_abs_err(
        dc.phase3(ct, sub, t, n, K, posbase),
        dc.phase3_plain(ct, sub, t, n, K, posbase)))
    torch.cuda.synchronize()
    return {**err, "dead_stop_change": dead_stop,
            "smem_table": dc.table_in_smem(ct.n_states, ct.n_classes, K)}


def b1_calls(ct, t: torch.Tensor, n: int) -> dict:
    """Thunks of the split route's pieces on this padded CUDA text:
    dfa_phase1 and dfa_phase3 (and their plain versions), the suffix scan
    and l_arrays_device. With --port-root naming an older checkout whose
    kernels took int32 class and start-state views (`pipeline.views`), its
    kernels are driven through that interface (no plain versions), for the
    before column."""
    from rejit_tpu_torch.engine import pipeline
    from rejit_tpu_torch.kernels import dfa_cuda as dc

    eseed = pipeline.eot_seed(ct, n)
    if hasattr(pipeline, "views"):
        v = pipeline.views(ct, t, K)
        C = ct.n_classes
        summ = dc.phase1(ct.packed, C, v.cls_kb, n)
        suf = pipeline.suffix_scan(summ, eseed)
        calls = {
            "dfa_phase1": lambda: dc.phase1(ct.packed, C, v.cls_kb, n),
            "dfa_phase3": lambda: dc.phase3(ct.packed, C, suf, v.cls_kb,
                                            v.startsb, n),
        }
    else:
        summ = dc.phase1(ct, t, n, K)
        suf = pipeline.suffix_scan(summ, eseed)
        calls = {
            "dfa_phase1": lambda: dc.phase1(ct, t, n, K),
            "dfa_phase3": lambda: dc.phase3(ct, suf, t, n, K),
            "dfa_phase1_plain": lambda: dc.phase1_plain(ct, t, n, K),
            "dfa_phase3_plain": lambda: dc.phase3_plain(ct, suf, t, n, K),
        }
    calls["suffix_scan"] = lambda: pipeline.suffix_scan(summ, eseed)
    calls["l_arrays_device"] = lambda: pipeline.l_arrays_device(ct, t, n,
                                                                block=K)
    return calls, suf


def b1_work(ct, t: torch.Tensor, n: int, suf) -> dict:
    """The work dfa_phase1 and dfa_phase3 need on this padded text, counted
    exactly by torch passes on the card: the live steps (from a state other
    than the dead one, at a position below n, inside the block) of every
    (block, start state) and of every boundary; phase 3's splices (end
    state not dead: one m_suf read) and their hits (m_suf >= 0: one i_suf
    read)."""
    from rejit_tpu_torch.kernels import dfa_cuda as dc

    C, Q, dead = ct.n_classes, ct.n_states, ct.dead
    cls_kb, startsb, pos_kb = dc.block_views(ct, t, K)
    nb = cls_kb.shape[1]
    S = torch.arange(Q, dtype=torch.int32, device=t.device)[:, None]
    S = S.repeat(1, nb)
    p1 = torch.zeros((), dtype=torch.int64, device=t.device)
    for k in range(K):
        active = (pos_kb[k] < n)[None, :] & (S != dead)
        p1 += active.sum()
        val = ct.packed[(S * C + cls_kb[k][None, :]).long()]
        S = torch.where(active, val >> 8, S)
    del S
    rows = torch.arange(K, dtype=torch.int32, device=t.device)[:, None]
    cls_pad = torch.cat([cls_kb, torch.zeros_like(cls_kb)], dim=0)
    S = startsb
    p3 = torch.zeros((), dtype=torch.int64, device=t.device)
    for j in range(K):
        active = (rows + j < K) & (pos_kb + j < n) & (S != dead)
        p3 += active.sum()
        val = ct.packed[(S * C + cls_pad[j:j + K]).long()]
        S = torch.where(active, val >> 8, S)
    live = S != dead
    hits = live & (torch.gather(suf[1], 1, S.T.long()).T >= 0)
    return {"p1_steps": int(p1), "p3_steps": int(p3),
            "p3_splices": int(live.sum()), "p3_tail_hits": int(hits.sum())}


def instances(Q: int) -> tuple:
    """The schain_fused instances that take Q states."""
    return ("sweep", "tile") if Q <= 32 else ("tile",)


def fused_call(sc, ct, inst: str):
    """The call that runs schain_fused instance `inst` on these tables:
    the wrapper for the instance it picks, else the tile hook."""
    if inst == sc.instance_for(ct.n_states):
        return sc.schain_fused
    return sc._schain_fused_tile


def sweep_edges(ct, text: torch.Tensor, mode: str,
                emit_f: bool = False) -> tuple:
    """(tile edge inside a chunk, chunk edge, segment edge) of the sweep
    instance on this text in `mode` (with F written, for emit_f), from the
    geometry the wrapper takes on the text's card: the segment edge in the
    middle of the text, the end of the 5th chunk past it, and half a chunk
    past the end of the 6th."""
    from rejit_tpu_torch.kernels import schain_cuda as sc

    P = text.shape[0]
    with torch.cuda.device(text.device):
        blocks = sc._sweep_blocks(text.device.index, mode, emit_f)
    W, _, tpc, nseg = sc.sweep_geometry(ct.n_states, P, blocks)
    check(tpc > 1, f"{P} bytes: one tile a chunk, no tile edge inside one")
    chunk = tpc * sc.SWEEP_TILE
    seg = nseg // 2 * (sc.SWEEP_THREADS // W) * chunk
    return (min(P, seg + 6 * chunk + tpc // 2 * sc.SWEEP_TILE),
            min(P, seg + 5 * chunk), min(P, seg))


def fused_vs_plain(ct, text: torch.Tensor, ns, modes=("l", "li", "count"),
                   seeds=("solo", "neutral"), block: int = K,
                   edges: bool = False, emit_f: bool = False,
                   first_starts=(None,)) -> dict:
    """Max |schain_fused - schain_fused_plain| (L, I, count and G; with
    emit_f, F on boundaries 0..n, and F past n apart as `f_past_n_err`)
    over the n values (with `edges`, also each mode's `sweep_edges`,
    where the sweep takes Q, and `tile_edges`),
    seeds, boundary-0 start states, modes, the FF skip on/off and the
    kernel instances that take these tables, on the same CUDA text; and
    the tiles each instance skipped with the skip on."""
    from rejit_tpu_torch.kernels import schain_cuda as sc

    err = past = calls = 0
    insts = instances(ct.n_states)
    skipped = dict.fromkeys(insts, 0)
    tiles = dict.fromkeys(insts, 0)
    ns_of = {m: tuple(ns) + ((sweep_edges(ct, text, m, emit_f)
                              if "sweep" in insts else ())
                             + tile_edges(ct, text, m) if edges else ())
             for m in modes}
    for mode in modes:
        for n in ns_of[mode]:
            for name in seeds:
                seed = (sc.solo_seed(ct, n) if name == "solo"
                        else sc.neutral_seed(ct.n_states, text.device))
                for fs in first_starts:
                    kw = dict(block=block, mode=mode, first_start=fs)
                    if emit_f:
                        kw["emit_f"] = True
                    want = sc.schain_fused_plain(ct, text, n, seed, **kw)
                    for inst in insts:
                        run = fused_call(sc, ct, inst)
                        for use_ff in (True, False):
                            stats = {}
                            got = run(ct, text, n, seed, use_ff=use_ff,
                                      stats=stats, **kw)
                            check(stats["instance"] == inst,
                                  "instance taken")
                            if emit_f:
                                past = max(past, max_abs_err(
                                    got[3][n + 1:], want[3][n + 1:]))
                                got = got[:3] + (got[3][:n + 1],)
                                want_n = want[:3] + (want[3][:n + 1],)
                            else:
                                want_n = want
                            err = max(err, max_abs_err(got, want_n))
                            calls += 1
                            if use_ff:
                                skipped[inst] += int(stats["skipped_tiles"])
                                tiles[inst] += stats["tiles"]
    torch.cuda.synchronize()
    out = {"max_abs_err": err, "calls": calls, "instances": list(insts),
           "ns": ns_of, "tiles": tiles, "skipped_tiles": skipped}
    if emit_f:
        out["f_past_n_err"] = past
    return out


def tile_edges(ct, text: torch.Tensor, mode: str) -> tuple:
    """(tile edge inside a segment, grid-range edge inside a tile, segment
    edge) of the tile instance on this text in `mode`, from the geometry
    the wrapper takes on the text's card: the segment edge in the middle of
    the text, one tile past it, and one tile and one grid range (or half a
    tile, when a range is a whole tile) past that."""
    from rejit_tpu_torch.kernels import schain_cuda as sc

    P = text.shape[0]
    Q, C = ct.n_states, ct.n_classes
    with torch.cuda.device(text.device):
        blocks = sc._tile_blocks(text.device.index, mode, Q, C,
                                 sc.grid_nb(Q))
    NB, _, tps, nseg = sc.geometry(Q, P, blocks)
    check(tps > 1, f"{P} bytes: one tile a segment, no tile edge inside one")
    seg = nseg // 2 * tps * sc.TILE
    inner = min(NB * sc.PIECE, sc.TILE // 2)
    return (min(P, seg + sc.TILE), min(P, seg + sc.TILE + inner),
            min(P, seg))


def log_text(size: int, corpus=None) -> bytes:
    """The log-search workloads' text (LOG_SEED), from `corpus` (a module
    with make_log_corpus; default this checkout's port)."""
    if corpus is None:
        from rejit_tpu_torch.utils import corpus
    return corpus.make_log_corpus(size, seed=LOG_SEED)


def own_corpus():
    """This script's checkout's rejit_tpu_torch/utils/corpus.py, loaded on
    its own (numpy only): --times tile --port-root DIR times an older port
    on the same log text, whatever that port's corpus module holds."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "rejit_tpu_torch", "utils", "corpus.py")
    spec = importlib.util.spec_from_file_location("_smoke_corpus", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def re_tokens(pattern: bytes, text: bytes) -> list:
    """(start, end, pattern id) of re.finditer, the id from the named group
    p<i> that matched (0 for a pattern without groups named so)."""
    out = []
    for m in re.finditer(pattern, text):
        g = m.lastgroup
        out.append((m.start(), m.end(), int(g[1:]) if g else 0))
    return out


def tile_workloads(rt, corpus=None, sizes=LOG_SIZES) -> list:
    """[(label, size, pattern, mode, text)] of the tile instance's timed
    rows: the four log patterns (L and count modes; "d" in L+I) and the
    line-long case (`LINES_PATTERN`) over the log text, config 3's tables,
    and the no-die cases (`NODIE_PATTERN`, `NODIE_WIDE_PATTERN`) over
    words_text, at each size. Texts are made once a size (a generator: one
    size in memory)."""
    from rejit_tpu_torch.utils.corpus import make_corpus

    for size in sizes:
        text = log_text(size, corpus)
        for name, pat in LOG_PATTERNS.items():
            mode = "li" if isinstance(pat, list) else "l"
            yield name, size, pat, mode, text
        yield "lines", size, LINES_PATTERN, "l", text
        del text
        text = make_corpus(size, seed=2, needle=b"matching", density=0.01)
        yield "config3", size, MAIN_PATTERN, "l", text
        text = words_text(size)
        yield "nodie", size, NODIE_PATTERN, "l", text
        yield "nodie_wide", size, NODIE_WIDE_PATTERN, "l", text
        del text


def time_tile_row(rt, name: str, size: int, pat, mode: str, text: bytes,
                  reps: int) -> dict:
    """The tile instance (the `_schain_fused_tile` hook) on one workload:
    device ms by CUDA events in `mode` and the count mode, with the card."""
    from rejit_tpu_torch.kernels import schain_cuda as sc

    ct = dfa_tables(rt, pat)
    t = padded(text, DEV)
    n = len(text)
    seed = sc.solo_seed(ct, n)
    row = {"workload": name, "n": n, "Q": ct.n_states, "C": ct.n_classes,
           "patterns": ct.n_patterns, "mode": mode}
    for key, m in (("ms", mode), ("count_ms", "count")):
        row[key] = time_ms(lambda: sc._schain_fused_tile(
            ct, t, n, seed, block=K, mode=m), reps)
    return row


def tile_times(rt, reps: int) -> None:
    """--times tile: the tile instance's rows only, for the imported port
    (DIR may hold an older checkout): each tile_workloads row, one line
    each, on the log text of this script's own checkout."""
    corpus = own_corpus()
    card = nvidia_smi("name,power.limit")
    for name, size, pat, mode, text in tile_workloads(rt, corpus):
        r = reps if size < (1 << 26) else max(2, reps // 4)
        emit({"phase": "times_tile", "card": card, **time_tile_row(
            rt, name, size, pat, mode, text, r)})


# The benchmark cells' patterns (portbench/configs), for --times count.
COUNT_PATTERNS = {"tokenizer": [r"\w+", r"\s+", r"[^\w\s]+"],
                  "class": "[a-z]+", "literals": "foo|bar|baz"}
COUNT_SIZES = (10_000_000, 1 << 28)


def count_times(rt, reps: int) -> None:
    """--times count: match_all_count of the benchmark cells' patterns on
    a staged make_corpus text (needle `foo` at 0.001) of 10 MB and 256
    MiB, for the imported port (DIR may hold an older checkout): each
    call's host wall until its count is on the host, with torch's
    profiler off and then recording (CPU and CUDA activity), and
    last_stats.device_time_s; medians of `reps` calls after a warm one,
    one line a pattern and size."""
    from torch.profiler import ProfilerActivity, profile

    from rejit_tpu_torch.utils.corpus import make_corpus

    card = nvidia_smi("name,power.limit")
    for n in COUNT_SIZES:
        corpus = rt.stage(make_corpus(n, seed=3, needle=b"foo",
                                      density=0.001), "cuda")
        r = reps if n < (1 << 26) else max(5, reps // 2)
        for name, pat in COUNT_PATTERNS.items():
            p = rt.Pattern(pat, device="cuda")
            want = p.match_all_count(corpus)
            off, dev = [], []
            for _ in range(r):
                t0 = time.perf_counter()
                check(p.match_all_count(corpus) == want, "count changed")
                off.append(time.perf_counter() - t0)
                dev.append(p.last_stats.device_time_s)
            on = []
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                for _ in range(r):
                    t0 = time.perf_counter()
                    p.match_all_count(corpus)
                    on.append(time.perf_counter() - t0)
            emit({"phase": "times_count", "card": card, "pattern": name,
                  "n": n, "calls": r, "count": want,
                  "wall_ms": 1e3 * float(np.median(off)),
                  "wall_ms_profiled": 1e3 * float(np.median(on)),
                  "device_time_ms": 1e3 * float(np.median(dev))})
        del corpus


def tile_work(ct, t: torch.Tensor, n: int) -> dict:
    """The tile instance's walk-path work on this text, counted with torch
    ops on t's device: each boundary below n whose start state is live
    walks to the dead state or its tile's end (sc.TILE bytes, or n); the
    steps a byte, the boundaries a byte with a first step, and the longest
    walk. The grid path's is 2*Q + 16.5 steps a byte."""
    from rejit_tpu_torch.kernels import schain_cuda as sc

    dead = ct.plan.dead
    C = ct.n_classes
    P = t.shape[0]
    dev = t.device
    cls = ct.class_of.long()[t.long()]
    S = torch.empty(P, dtype=torch.long, device=dev)
    S[0] = ct.plan.start_by_ctx[0]
    S[1:] = ct.start_of_byte.long()[t[:-1].long()]
    pos = torch.arange(P, device=dev)
    end = torch.clamp((pos // sc.TILE + 1) * sc.TILE, max=n)
    live = pos < end
    if dead is not None:
        live &= S != dead
    idx = live.nonzero().flatten()
    cur, j = S[idx], idx.clone()
    packed = ct.packed.long()
    steps, first, longest = 0, idx.numel(), 0
    while idx.numel():
        v = packed[cur * C + cls[j]]
        cur, j = v >> 8, j + 1
        steps += idx.numel()
        longest += 1
        keep = j < end[idx]
        if dead is not None:
            keep &= cur != dead
        idx, cur, j = idx[keep], cur[keep], j[keep]
    return {"live_steps_per_byte": steps / max(1, n),
            "first_steps_per_byte": first / max(1, n),
            "longest_walk": longest}


def log_bounds(n: int, Q: int, mode: str) -> dict:
    """The two bounds of a tile-instance row: the bytes it must move (the
    text read once, L written once, and I in L+I mode: 5 or 9 B a byte;
    1 B in count mode) over HBM bandwidth, and Q automaton steps a byte
    (the backward composition over the Q states), one shared-memory table
    load each, at the card's shared-memory load rate."""
    per = {"l": 5, "li": 9, "count": 1}[mode]
    return {"bytes_bound_ms": per * n / HBM_BYTES_PER_S * 1e3,
            "steps_bound_ms": Q * n / SMEM_LOADS_PER_S * 1e3}


def log_phase(rt, reset, launches, only, quick: bool) -> dict:
    """The log-search workloads on the tile instance (LOG_PATTERNS over
    the log text at 10 MB and 256 MiB): each pattern takes the fused route
    and the tile instance with one schain_fused call a match_all_arrays
    call; at 10 MB its spans (and pattern ids) equal Python `re` and the
    port's CPU run, and the kernel is held bit-equal to its plain version
    at the tile instance's own tile, range and segment edges, as it is on
    LINES_PATTERN and NODIE_WIDE_PATTERN. Outside --quick: the kernel's device ms in the pattern's mode and the count
    mode (CUDA events) and match_all_arrays's walls, from host bytes and
    staged, with the bounds; each row with the card's name and power
    limit. Returns {"max_abs_err": .., "calls": .., "rows": [..]}."""
    from rejit_tpu_torch.kernels import schain_cuda as sc

    card = nvidia_smi("name,power.limit")
    err = calls = 0
    rows = []
    sizes = LOG_SIZES[:1] if quick else LOG_SIZES
    for size in sizes:
        text = log_text(size)
        for name, pat in LOG_PATTERNS.items():
            p = rt.Pattern(pat, device=DEV)
            ct = p.ct
            mode = "li" if ct.n_patterns > 1 else "l"
            check(p.engine == "dfa" and p.fused
                  and sc.instance_for(ct.n_states) == "tile",
                  f"log {name}: engine {p.engine}, fused {p.fused}, "
                  f"Q {ct.n_states}")
            with Recorder([(sc, "_fused")]) as rec:
                reset()
                out = p.match_all_arrays(text)
                got_launches = launches()
            check(only(got_launches, schain_fused=1),
                  f"log {name}: {got_launches}")
            check([c[1][4] for c in rec.calls] == ["tile"],
                  f"log {name}: instances {[c[1][4] for c in rec.calls]}")
            row = {"workload": name, "n": size, "Q": ct.n_states,
                   "C": ct.n_classes, "patterns": ct.n_patterns,
                   "mode": mode, "matches": len(out[0]),
                   "launches": got_launches, "card": card}
            if size == LOG_SIZES[0]:
                toks = list(zip(out[0].tolist(), out[1].tolist(),
                                out[2].tolist()))
                want = re_tokens(LOG_RE[name], text)
                check(toks == want, f"log {name}: spans differ from re "
                      f"({len(toks)} vs {len(want)})")
                cpu = rt.Pattern(pat, device="cpu").match_all_arrays(text)
                check(all(np.array_equal(a, b) for a, b in zip(out, cpu)),
                      f"log {name}: card and CPU runs differ")
                t = padded(text, DEV)
                e = fused_vs_plain(ct, t, (size, size - 3) + tile_edges(
                    ct, t, mode), modes=(mode, "count"))
                err = max(err, e["max_abs_err"])
                calls += e["calls"]
                row.update(equal_to_re=True, equal_to_cpu=True,
                           kernel_vs_plain=e["max_abs_err"],
                           edges=e["ns"], **tile_work(ct, t, size))
                del t
            if not quick:
                reps = 20 if size < (1 << 26) else 5
                row.update(time_tile_row(rt, name, size, pat, mode, text,
                                         reps))
                for m in (mode, "count"):
                    row.update({f"{m}_{k}": v for k, v in log_bounds(
                        size, ct.n_states, m).items()})
                corpus = rt.stage(text, DEV)
                wr = 5 if size < (1 << 26) else 3
                row["match_all"] = wall_s(lambda: p.match_all_arrays(text),
                                          wr)
                row["match_all_staged"] = wall_s(
                    lambda: p.match_all_arrays(corpus), wr)
                del corpus
            emit({"phase": "log_search", **row})
            rows.append(row)
        if size == LOG_SIZES[0]:
            # The timed worst cases of `--times tile` that the wrapper gives
            # the tile instance: kernel = plain at its edges.
            for name, pat, txt in (("lines", LINES_PATTERN, text),
                                   ("nodie_wide", NODIE_WIDE_PATTERN,
                                    words_text(size))):
                ct = dfa_tables(rt, pat)
                check(sc.instance_for(ct.n_states) == "tile",
                      f"{name}: Q {ct.n_states}")
                t = padded(txt, DEV)
                e = fused_vs_plain(ct, t, (size, size - 3) + tile_edges(
                    ct, t, "l"), modes=("l", "count"))
                err = max(err, e["max_abs_err"])
                calls += e["calls"]
                row = {"phase": "log_search_worst", "workload": name,
                       "n": size, "Q": ct.n_states, "C": ct.n_classes,
                       "kernel_vs_plain": e["max_abs_err"], "edges": e["ns"]}
                if name == "lines":     # no-die walks run to every tile end
                    row.update(tile_work(ct, t, size))
                emit(row)
                del t
        del text
    return {"max_abs_err": err, "calls": calls, "rows": rows}


def spans_of(out) -> list:
    return list(zip(out[0].tolist(), out[1].tolist()))


def re_spans(pattern: bytes, text: bytes) -> list:
    return [m.span() for m in re.finditer(pattern, text)]


def bound(nbytes: float, ops: float) -> dict:
    """The larger of `nbytes` over HBM bandwidth and `ops` ALU
    instructions over the lane issue rate."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / PEAK_LANE_OPS_PER_S
    return {"bound_ms": max(tb, to) * 1e3,
            "bound_by": "bytes" if tb >= to else "operations",
            "bytes": nbytes, "ops": ops}


def kernel_bounds(n: int, P: int, Q: int, C: int) -> dict:
    """{kernel: {bound_ms, bound_by, bytes, ops}} of the fused function:
    the larger of the bytes it must move (the uint8 text and the table
    read once, L written once: 4 B a byte for one pattern, nothing in the
    count mode) over HBM bandwidth and its ALU instructions over the lane
    issue rate, at Q automaton steps per text byte below n (its L can be
    composed backward over the Q states)."""
    tab = Q * C * 4
    ops = ALU_OPS_PER_STEP * min(n, P) * Q
    return {
        "schain_fused": bound(P + tab + 4 * P, ops),
        "schain_fused_count": bound(P + tab, ops),
    }


def b1_bounds(P: int, Q: int, C: int, work: dict) -> dict:
    """{kernel: {bound_ms, bound_by, bytes, ops}} of dfa_phase1 and
    dfa_phase3. Bytes: the uint8 text once, the table and the 256-entry
    byte maps, the outputs ((f, m, i) each (nb, Q); L and I each P int32)
    and, for phase 3, the suffix entries its splices read (`work`).
    Operations: the live steps these inputs need (`work`, counted on the
    card by b1_work), ALU_OPS_PER_STEP each."""
    nb = P // K
    tab = Q * C * 4
    p1 = P + tab + 256 * 4 + 3 * nb * Q * 4
    p3 = (P + tab + 2 * 256 * 4 + 2 * P * 4
          + 4 * (work["p3_splices"] + work["p3_tail_hits"]))
    return {"dfa_phase1": bound(p1, ALU_OPS_PER_STEP * work["p1_steps"]),
            "dfa_phase3": bound(p3, ALU_OPS_PER_STEP * work["p3_steps"])}


def time_b1(rt, pats, text: bytes, reps: int, plain_reps: int,
            wall_reps: int = 0) -> dict:
    """The split route on this text (the pattern's DFA tables, K = 32):
    device times of dfa_phase1, dfa_phase3, their plain versions, the
    suffix scan and l_arrays_device by CUDA events; l_arrays_device's peak
    device memory beyond its inputs; with wall_reps, match_all_arrays's
    host-clock wall on the split route; and, for this checkout's port, the
    work these inputs need (b1_work) and the kernels' bounds from it."""
    from rejit_tpu_torch.kernels import dfa_cuda as dc

    q = rt.Pattern(pats, rt.Config(engine="dfa", schain_fused="off"),
                   device=DEV)
    ct = q.ct
    n = len(text)
    t = padded(text, DEV)
    P = t.shape[0]
    Q, C = ct.n_states, ct.n_classes
    res = {"n": n, "P": P, "Q": Q, "C": C, "table_bytes": Q * C * 4}
    calls, suf = b1_calls(ct, t, n)
    for name, fn in calls.items():
        if name.endswith("_plain"):
            res[name + "_ms"] = time_ms(fn, plain_reps, 1)
        else:
            res[name + "_ms"] = time_ms(fn, reps)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    calls["l_arrays_device"]()
    torch.cuda.synchronize()
    res["l_arrays_device_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                         - base)
    if hasattr(dc, "block_views"):
        res["table_in_smem"] = dc.table_in_smem(Q, C, K)
        work = b1_work(ct, t, n, suf)
        res.update(work)
        for name, b in b1_bounds(P, Q, C, work).items():
            res[name + "_bound_ms"] = b["bound_ms"]
            res[name + "_bound_by"] = b["bound_by"]
    del calls, suf
    if wall_reps:
        res["match_all_split_wall"] = wall_s(lambda: q.match_all_arrays(text),
                                             wall_reps)
    return res


def kernel_split(fn, reps: int) -> dict:
    """Device ms per call of each CUDA kernel fn() launches, from
    torch.profiler (CUPTI); {"error": ...} when it records no device time,
    which leaves the split not measured."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0)
            if us > 0:
                out[e.key] = us / reps / 1e3
    except Exception as exc:  # the measurement only; no result depends on it
        return {"error": repr(exc)}
    return out or {"error": "no device time recorded"}


def time_launches(rt, text: bytes, label: str, reps: int) -> dict:
    """schain_fused per launch (summary, carry, emit) in both instances,
    by the profiler. Run after every CUDA-event timing: once the profiler
    has run, later launches in the process time slower."""
    from rejit_tpu_torch.kernels import schain_cuda as sc

    ct = dfa_tables(rt, MAIN_PATTERN)
    t = padded(text, DEV)
    n = len(text)
    seed = sc.solo_seed(ct, n)

    def fused(mode, inst):
        run = fused_call(sc, ct, inst)
        return lambda: run(ct, t, n, seed, block=K, mode=mode)

    return {"label": label,
            "schain_fused_launch_ms": kernel_split(fused("l", "sweep"), reps),
            "schain_fused_count_launch_ms": kernel_split(
                fused("count", "sweep"), reps),
            "schain_fused_tile_launch_ms": kernel_split(fused("l", "tile"),
                                                        reps)}


def time_size(rt, text: bytes, label: str, reps: int,
              wall_reps: int) -> tuple:
    """Device times of each stage and entry-point walls at one text size."""
    from rejit_tpu_torch.engine import select
    from rejit_tpu_torch.kernels import dfa_cuda as dc
    from rejit_tpu_torch.kernels import schain_cuda as sc

    n = len(text)
    p = rt.Pattern(MAIN_PATTERN, device=DEV)
    q = rt.Pattern(MAIN_PATTERN, rt.Config(schain_fused="off"), device=DEV)
    cp = rt.Pattern(COUNT_PATTERN, rt.Config(engine="dfa"), device=DEV)
    check(p.fused and not q.fused and cp.fused, "routes")
    ct = p.ct
    C, Q = ct.n_classes, ct.n_states
    dev_text = padded(text, DEV)
    P = dev_text.shape[0]
    plain_reps = max(1, reps // 4)
    res = {"label": label, "n": n, "P": P, "Q": Q, "C": C, "K": K}

    # The fused route: the sweep instance (the main path's, Q <= 32) and
    # the tile instance (the design before it) in turns, per mode.
    seed = sc.solo_seed(ct, n)
    NB, ntiles, tps, nseg = sc.geometry(Q, P, sc._tile_blocks(
        dev_text.device.index, "l", Q, C, sc.grid_nb(Q)))
    W, sw_tiles, tpc, sw_nseg = sc.sweep_geometry(
        Q, P, sc._sweep_blocks(dev_text.device.index, "l"))
    res.update({"tiles": ntiles, "tile_bytes": sc.TILE, "segments": nseg,
                "grid_range_bytes": NB * sc.PIECE,
                "sweep_width": W, "sweep_tiles": sw_tiles,
                "sweep_chunk_bytes": tpc * sc.SWEEP_TILE,
                "sweep_segments": sw_nseg})

    def fused(mode, inst="sweep"):
        run = fused_call(sc, ct, inst)
        return lambda: run(ct, dev_text, n, seed, block=K, mode=mode)

    for key, mode in (("", "l"), ("_count", "count"), ("_li", "li")):
        t = {"sweep": [], "tile": []}
        for inst in ("sweep", "tile", "tile", "sweep"):
            t[inst].append(time_ms(fused(mode, inst), reps))
        res[f"schain_fused{key}_ms"] = float(np.mean(t["sweep"]))
        res[f"schain_fused{key}_tile_ms"] = float(np.mean(t["tile"]))
    res.update({
        "schain_fused_plain_ms": time_ms(
            lambda: sc.schain_fused_plain(ct, dev_text, n, seed, block=K,
                                          mode="l"), plain_reps, 1),
        "schain_fused_count_plain_ms": time_ms(
            lambda: sc.schain_fused_plain(ct, dev_text, n, seed, block=K,
                                          mode="count"), plain_reps, 1),
        "fused_l_arrays_ms": time_ms(
            lambda: sc.l_arrays_device_staged(ct, dev_text, n, block=K),
            reps),
    })
    dc.reset_launches()
    sc.reset_launches()
    sc.l_arrays_device_staged(ct, dev_text, n, block=K)
    res["schain_fused_launches_per_call"] = sc.LAUNCHES["schain_fused"]

    # The split route (the fused route's tables, with schain_fused='off').
    del dev_text
    res.update(time_b1(rt, MAIN_PATTERN, text, reps, plain_reps))
    for name, b in kernel_bounds(n, P, Q, C).items():
        res[name + "_bound_ms"] = b["bound_ms"]
        res[name + "_bound_by"] = b["bound_by"]
    # suffix scan: its summaries read once and its suffixes written once
    res["suffix_scan_bound_ms"] = 6 * (P // K) * Q * 4 / HBM_BYTES_PER_S * 1e3

    # Entry points end to end (host clock, after a warm-up).
    corpus = rt.stage(text, DEV)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    out = p.match_all_arrays(text)
    res["fused_peak_device_bytes_per_text_byte"] = (
        torch.cuda.max_memory_allocated() - base_mem) / n
    walls = {
        "match_all": wall_s(lambda: p.match_all_arrays(text), wall_reps),
        "match_all_staged": wall_s(lambda: p.match_all_arrays(corpus),
                                   wall_reps),
        "match_all_count": wall_s(lambda: p.match_all_count(text),
                                  wall_reps),
        "match_all_split": wall_s(lambda: q.match_all_arrays(text),
                                  wall_reps),
        "count_mode_match_all_count": wall_s(
            lambda: cp.match_all_count(text), wall_reps),
    }
    for k, w in walls.items():
        res[k + "_wall"] = w
        res[k + "_GBps"] = n / w["median_s"] / 1e9
    p.match_all_arrays(text)
    res["match_all_device_s"] = p.last_stats.device_time_s
    res["match_all_select_s"] = p.last_stats.select_time_s
    res["matches"] = len(out[0])
    out_split = q.match_all_arrays(text)
    check(all(np.array_equal(a, b) for a, b in zip(out, out_split)),
          f"{label}: fused and split routes differ")
    # Selection with and without the all-disjoint shortcut. Every candidate
    # of this pattern is selected (n_cand equals the matches), so the
    # selected spans are the candidate list the greedy pass walks.
    check(p.last_stats.n_candidates == len(out[0]),
          f"candidates {p.last_stats.n_candidates} != matches {len(out[0])}")
    t0 = time.perf_counter()
    sel = select.match_all_candidates(*out, native=True)
    res["select_shortcut_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loop = select.greedy(*out)
    res["select_greedy_loop_s"] = time.perf_counter() - t0
    check(all(np.array_equal(a, b) for a, b in zip(sel, loop)),
          "greedy loop and shortcut differ")
    return res, out


def sparse_text(size: int, seed: int) -> bytes:
    """Punctuation and spaces with a rare word every few thousand bytes:
    most 32-byte blocks (and 2 KB tiles) hold no word byte, so the split
    route's fast-forward runs phase 3 on the gathered candidate blocks only
    and the fused kernel skips tiles."""
    rng = np.random.default_rng(seed)
    buf = rng.choice(np.frombuffer(b".,;:-!? ", np.uint8), size=size)
    words = [b"singing", b"ring", b"sting9", b"ingot", b"mingling"]
    at = np.sort(rng.choice(size - 16, size=size // 4000, replace=False))
    for j, a in enumerate(at):
        w = words[j % len(words)]
        buf[a:a + len(w)] = np.frombuffer(w, np.uint8)
    return buf.tobytes()


def literal_sets(rng) -> list:
    """(lits, pids) sets of 1, 3, 9 and 15 distinct literals, lengths 1 to
    128, and a set of 1-, 3-, 4-, 5- and 8-byte literals (around a word
    and the kernel's 8-byte prefix), over the alphabet of `literal_text`,
    pids below 16."""
    alphabet = np.frombuffer(b"ab c", np.uint8)
    lengths = (1, 2, 3, 5, 8, 17, 31, 64, 100, 127, 128)
    sets = []
    for k in (1, 3, 9, 15):
        lits = {b"a"}
        if k > 1:
            lits.add(rng.choice(alphabet, size=128).tobytes())
        while len(lits) < k:
            lits.add(rng.choice(alphabet, size=int(rng.choice(lengths)))
                     .tobytes())
        lits = tuple(sorted(lits))
        sets.append((lits, tuple(int(p) for p in
                                 rng.integers(0, 16, size=len(lits)))))
    lits = tuple(sorted({rng.choice(alphabet, size=m).tobytes()
                         for m in (1, 3, 4, 4, 5, 5, 8, 8)}))
    sets.append((lits, tuple(int(p) for p in
                             rng.integers(0, 16, size=len(lits)))))
    return sets


def literal_text(rng, sets, size: int) -> np.ndarray:
    """Random bytes over the literals' alphabet with every literal planted
    many times, so long ones hit and short ones crowd rows past cap 16."""
    text = rng.choice(np.frombuffer(b"ab c", np.uint8), size=size)
    for lits, _ in sets:
        for lit in lits:
            for at in rng.choice(size - 200, size=40, replace=False):
                text[at:at + len(lit)] = np.frombuffer(lit, np.uint8)
    return text


def literal_spans_vs_plain(xc, text: np.ndarray, sets, caps=(0, 2, 4, 16),
                           max_len: int = 0) -> dict:
    """Max |literal_spans - literal_spans_plain| (keys and counts) on the
    same CUDA rows (padded as `pad_rows` pads for `max_len`, default a
    row), at each cap, n at the text's length, P, P-3, a row edge, a block
    edge (32 rows), 1 and 0."""
    rows = torch.from_numpy(xc.pad_rows(text, len(text),
                                        max_len or xc.CHL)).to(DEV)
    P = rows.numel()
    err, calls, max_count = 0, 0, 0
    ns = dict.fromkeys((len(text), P, P - 3, 777 * xc.CHL,
                        13 * 32 * xc.CHL, 1, 0))
    for lits, pids in sets:
        for cap in caps:
            for n in ns:
                want = xc.literal_spans_plain(rows, n, lits=lits, pids=pids,
                                              cap=cap)
                got = xc.literal_spans(rows, n, lits=lits, pids=pids,
                                       cap=cap)
                err = max(err, max_abs_err(got, want))
                calls += 1
                max_count = max(max_count, int(want[1].max()))
    torch.cuda.synchronize()
    return {"max_abs_err": err, "calls": calls, "P": P, "caps": list(caps),
            "max_row_count": max_count}


# The literal cell's pattern and corpus (portbench/configs/rejit-literals.json:
# `foo` at a word density of 0.001), where the literal_count kernel is timed.
LITCOUNT_PATTERN = "foo|bar|baz"
LITCOUNT_SIZES = (10_000_000, 256 << 20, 2_000_000_000)
# Lane instructions a text byte of the kernel's one-word instance counted
# every 8 bytes (csrc/literal_count.cu's header): the byte's extract, the
# table address and the shift (IMADs), the step's LOP3, and an eighth of
# the count's popc, AND and add.
LITCOUNT_OPS_PER_BYTE = 4.5


def literal_count_vs_plain(rt, lk, rng) -> dict:
    """Max |literal_count_device - literal_count_plain| on the same CUDA
    text: literal_sets' sets (one, two and four state words, several
    launches a set), a `(?i)` class-literal set and a 160-byte literal
    (past the state: its tail compared) over literal_text, at n = P, P - 3,
    3 segments, 1, 0, -5 and past P (a shard's n), each at the text's
    address and 5 bytes past it."""
    sets = [lits for lits, _ in literal_sets(rng)]
    sets.append(rt.Pattern("(?i)packet|state", device=DEV).info.literals)
    sets.append((b"ab c" * 40, b"a", b"ca"))
    text = literal_text(rng, [(s, None) for s in sets[:-2]], 300_000)
    text[1000:1160] = np.frombuffer(sets[-1][0], np.uint8)
    t = torch.from_numpy(text).to(DEV)
    err, calls, hits = 0, 0, 0
    for lits in sets:
        max_m = max(len(x) for x in lits)
        P = len(text) - max_m
        for n in (P, P - 3, 3 * lk.SEG_BYTES, 1, 0, -5, P + max_m - 1):
            for off in (0, 5):
                got = int(lk.literal_count_device(t[off:], n, lits=lits,
                                                  P=P - off))
                want = int(lk.literal_count_plain(t[off:], n, lits=lits,
                                                  P=P - off))
                err = max(err, abs(got - want))
                hits = max(hits, want)
                calls += 1
    torch.cuda.synchronize()
    return {"max_abs_err": err, "calls": calls, "max_count": hits,
            "groups": sorted({len(lk.count_tables(s)) for s in sets}),
            "words": sorted({g.words for s in sets
                             for g in lk.count_tables(s)})}


def literal_count_phase(rt, reset, launches, only, quick: bool) -> tuple:
    """The literal_count kernel: held against its plain version
    (literal_count_vs_plain), then its path, match_all_count of the
    literal cell's pattern on its corpus (portbench's generator, seed 7)
    staged at 10 MB: one launch and nothing else, the count equal to the
    plain version's and to `bytes.count` of each word; outside --quick the
    kernel's and the plain version's device ms (CUDA events) at
    LITCOUNT_SIZES beside the bound, and the staged call's wall. Returns
    (launches on the path, max_abs_err, times for the kernels line)."""
    from portbench.corpus import words
    from rejit_tpu_torch.kernels import literal as lk

    e = literal_count_vs_plain(rt, lk, np.random.default_rng(17))
    emit({"phase": "literal_count_vs_plain", **e})
    p = rt.Pattern(LITCOUNT_PATTERN, device=DEV)
    lits = p.info.literals
    check(p.engine == "literal" and p.info.overlap_free, "literal cell route")
    times = {}
    path_launches = 0
    for size in (LITCOUNT_SIZES[:1] if quick else LITCOUNT_SIZES):
        host = words.make(size, 7, DEV, "foo", 0.001).cpu().numpy()
        corpus = rt.stage(host, DEV)
        ext, P_arr = corpus.padded_ext(3)
        P = P_arr - 3
        want = int(lk.literal_count_plain(ext, size, lits=lits, P=P))
        reset()
        got = p.match_all_count(corpus)
        got_launches = launches()
        check(got == want and only(got_launches, literal_count=1),
              f"literal cell path at {size}: {got} vs {want}, "
              f"{got_launches}")
        if size == LITCOUNT_SIZES[0]:
            hb = host.tobytes()
            check(got == sum(hb.count(w) for w in (b"foo", b"bar", b"baz")),
                  "literal cell count differs from bytes.count")
            path_launches = got_launches["literal_count"]
        row = {"n": size, "count": got, "launches": got_launches}
        if not quick:
            reps = 20 if size < (1 << 30) else 10
            row.update({
                "ms": time_ms(lambda: lk.literal_count_device(
                    ext, size, lits=lits, P=P), reps),
                "plain_ms": time_ms(lambda: lk.literal_count_plain(
                    ext, size, lits=lits, P=P), 3, 1),
                **bound(size, LITCOUNT_OPS_PER_BYTE * size),
                "wall": wall_s(lambda: p.match_all_count(corpus), reps),
                "device_time_ms": 1e3 * p.last_stats.device_time_s,
            })
            row["pct_of_bound"] = 100 * row["bound_ms"] / row["ms"]
            if size == LITCOUNT_SIZES[0]:
                times = {"literal_count_" + k: row[k] for k in
                         ("ms", "plain_ms", "bound_ms", "bound_by")}
        emit({"phase": "literal_count_path", **row})
        del corpus, ext, host
        torch.cuda.empty_cache()
    return path_launches, e["max_abs_err"], times


SCAN_KINDS = ("random", "increasing", "decreasing", "constant",
              "int_extremes", "extremes_first_tile", "extremes_last_tile")
SCAN_REPEATS = 200


def scan_input(P: int, kind: str, tile: int, g) -> torch.Tensor:
    """An int32 input of length P on the card (SCAN_KINDS): random over the
    whole int32 range, that sorted up or down, constant, small values with
    INT_MIN and INT_MAX planted at random places, or small values with
    both extremes inside the first or the last tile of `tile` elements."""
    if kind == "constant":
        return torch.full((P,), -7, dtype=torch.int32, device=DEV)
    if kind in ("random", "increasing", "decreasing"):
        x = torch.randint(-2**31, 2**31, (P,), dtype=torch.int32, device=DEV,
                          generator=g)
        if kind != "random":
            x = torch.sort(x, descending=kind == "decreasing").values
        return x
    x = torch.randint(-1000, 1000, (P,), dtype=torch.int32, device=DEV,
                      generator=g)
    lo, hi = {"int_extremes": (0, P),
              "extremes_first_tile": (0, min(P, tile)),
              "extremes_last_tile": (max(0, P - tile), P)}[kind]
    at = torch.randint(lo, hi, (6,), device=DEV, generator=g)
    x[at[:3]] = -2**31
    x[at[3:]] = 2**31 - 1
    return x


def scan_vs_plain(sc, sizes, seed: int) -> dict:
    """Max |scan1d - plain| in both directions on every SCAN_KINDS input of
    each size; on offset views x[1:] (4 bytes off a 16-byte boundary) of
    three sizes; and SCAN_REPEATS times in a row at one tile, a few tiles
    and 10 M elements, every call compared (a look-back race shows only
    now and then). Also checks that each wrapper call counted exactly one
    scan1d call."""
    tile = sc._kernels().scan1d_tile_elems()
    g = torch.Generator(device=DEV).manual_seed(seed)
    sizes = sorted(set(sizes) | {tile - 1, tile, tile + 1, 2 * tile - 1,
                                 2 * tile, 2 * tile + 1})
    err, calls = 0, 0
    sc.reset_launches()

    def both(x):
        nonlocal err, calls
        err = max(err, max_abs_err(sc.rcummin(x), sc.rcummin_plain(x)),
                  max_abs_err(sc.cummax(x), sc.cummax_plain(x)))
        calls += 2

    for P in sizes:
        for kind in SCAN_KINDS:
            both(scan_input(P, kind, tile, g))
    offsets = (tile + 2, 5 * tile + 7, 10_000_001)
    for P in offsets:
        for kind in ("random", "extremes_first_tile", "extremes_last_tile"):
            x = scan_input(P, kind, tile, g)[1:]
            check(x.data_ptr() % 16 == 4, "the view is not 4 bytes off")
            both(x)
    repeats = (tile, 5 * tile + 3, 10_000_000)
    differing = 0
    for P in repeats:
        x = scan_input(P, "random", tile, g)
        want = sc.rcummin_plain(x), sc.cummax_plain(x)
        for _ in range(SCAN_REPEATS):
            got = sc.rcummin(x), sc.cummax(x)
            differing += sum(not torch.equal(a, b) for a, b in zip(got, want))
            calls += 2
    torch.cuda.synchronize()
    err = max(err, differing)
    check(sc.LAUNCHES["scan1d"] == calls,
          f"scan1d counted {sc.LAUNCHES['scan1d']} for {calls} calls")
    return {"max_abs_err": err, "calls": calls, "tile": tile,
            "sizes": sizes,
            "kinds": list(SCAN_KINDS), "offset_view_sizes": list(offsets),
            "repeated_sizes": list(repeats), "repeats": SCAN_REPEATS,
            "repeated_calls_differing": differing,
            "launches_per_call": sc.LAUNCHES["scan1d"] / calls}


def scan_profile(sc, reps: int) -> dict:
    """scan1d by torch.profiler (run after every CUDA-event timing): at 10 M
    and 256 Mi elements, both directions, the scan1d kernels a call (one),
    the memsets a call and the device ms a call of each; the bound beside.
    A launch-bound time by the events shows here as a shorter device
    time."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for n in (10_000_000, 1 << 28):
        x = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32,
                          device=DEV)
        for op in ("rcummin", "cummax"):
            fn = getattr(sc, op)
            fn(x)
            torch.cuda.synchronize()
            try:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(reps):
                        fn(x)
                    torch.cuda.synchronize()
            except Exception as exc:  # the measurement only
                out[f"{op}_{n}"] = {"error": repr(exc)}
                continue
            row = {"kernels_a_call": 0.0, "kernel_ms": 0.0,
                   "memsets_a_call": 0.0, "memset_ms": 0.0,
                   "bound_ms": 8 * n / HBM_BYTES_PER_S * 1e3}
            for e in prof.key_averages():
                us = getattr(e, "device_time_total", None)
                if us is None:
                    us = getattr(e, "cuda_time_total", 0)
                # Device operations only (not the runtime API's calls).
                key = ("kernel" if "scan1d" in e.key else "memset"
                       if "memset" in e.key.lower() else None)
                if key and us > 0:
                    row[key + "s_a_call"] += e.count / reps
                    row[key + "_ms"] += us / reps / 1e3
            out[f"{op}_{n}"] = row
        del x
    return out


def scan_paths_device_s(rt, text: bytes, label: str, reps: int) -> dict:
    """last_stats.device_time_s (median of reps calls after a warm one) of
    match_all_arrays on the classrun and classlit paths (B3_PATTERNS)."""
    res = {"label": label, "n": len(text)}
    for name, (pat, _) in B3_PATTERNS.items():
        bp = rt.Pattern(pat, device=DEV)
        bp.match_all_arrays(text)
        dev = []
        for _ in range(reps):
            bp.match_all_arrays(text)
            dev.append(bp.last_stats.device_time_s)
        res[name + "_device_s"] = float(np.median(dev))
        res[name + "_device_s_all"] = dev
    return res


def scan_times(rt, reps: int) -> None:
    """--times scan: scan1d's rows only, for the imported port: the kernel
    at 10 M and 256 Mi elements (CUDA events, both directions), the
    classrun and classlit paths' device_time_s at 10 MB and 256 MiB of
    config 3, then the profiler's scan1d device time (scan_profile)."""
    from rejit_tpu_torch.kernels import scan_cuda as sc
    from rejit_tpu_torch.utils.corpus import make_corpus

    for n, r in ((10_000_000, reps), (1 << 28, max(2, reps // 4))):
        x = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32,
                          device=DEV)
        emit({"phase": "scan_times", "n": n,
              "rcummin_ms": time_ms(lambda: sc.rcummin(x), r),
              "cummax_ms": time_ms(lambda: sc.cummax(x), r),
              "bound_ms": 8 * n / HBM_BYTES_PER_S * 1e3})
        del x
    for size, label, r in ((10_000_000, "10MB", 5), (256 << 20, "256MiB", 3)):
        text = make_corpus(size, seed=2, needle=b"matching", density=0.01)
        emit({"phase": "scan_paths_device_s",
              **scan_paths_device_s(rt, text, label, r)})
        del text
    emit({"phase": "scan_profile", **scan_profile(sc, reps)})


def literal_compares(rows: torch.Tensor, n: int, lits) -> int:
    """The byte compares literal_spans does on these rows: at each position
    below n - len + 1 not yet claimed, each literal in claim order costs one
    compare plus one per matched prefix byte (a full hit len compares, and
    it claims the position)."""
    flat = rows.reshape(-1)
    P = flat.numel()
    ext = torch.cat([flat, torch.zeros(max(len(l) for l in lits),
                                       dtype=torch.uint8, device=flat.device)])
    alive = torch.ones(P, dtype=torch.bool, device=flat.device)
    total = 0
    for lit in lits:
        m = alive.clone()
        m[max(0, n - len(lit) + 1):] = False
        total += int(m.sum())
        for j, b in enumerate(lit):
            m &= ext[j:j + P] == b
            if j + 1 < len(lit):
                total += int(m.sum())
        alive &= ~m
    return total


def time_literal_engines(rt, text: bytes, label: str, reps: int,
                         walls: bool) -> dict:
    """literal_spans on the keyword path's rows and scan1d on an int32
    array of the text's length: kernel, plain and library times (CUDA
    events) beside their bounds; with `walls`, the host-clock walls of the
    B4 and B3 paths' match_all_arrays."""
    from rejit_tpu_torch.kernels import extract_cuda as xc
    from rejit_tpu_torch.kernels import literal as lk
    from rejit_tpu_torch.kernels import scan_cuda as sc

    n = len(text)
    host = np.frombuffer(text, np.uint8)
    plain_reps = max(1, reps // 4)
    kp = rt.Pattern(b"|".join(KEYWORDS), device=DEV)
    lits, pids = kp.info.literals, kp.info.literal_pids
    rows = torch.from_numpy(xc.pad_rows(host, n, 6)).to(DEV)
    _, cnt = xc.literal_spans(rows, n, lits=lits, pids=pids, cap=0)
    cap = 4
    while cap < int(cnt.max()):
        cap *= 2
    Rows = rows.shape[0]
    order = [lits[i] for i in lk.claim_order(lits, pids)]
    compares = literal_compares(rows, n, order)
    tb = (rows.numel() + Rows * (cap + 1) * 4) / HBM_BYTES_PER_S
    to = compares / PEAK_LANE_OPS_PER_S
    res = {
        "label": label, "n": n, "rows": Rows, "cap": cap,
        "literal_spans_compares": compares,
        "literal_spans_ms": time_ms(lambda: xc.literal_spans(
            rows, n, lits=lits, pids=pids, cap=cap), reps),
        "literal_spans_count_only_ms": time_ms(lambda: xc.literal_spans(
            rows, n, lits=lits, pids=pids, cap=0), reps),
        "literal_spans_plain_ms": time_ms(lambda: xc.literal_spans_plain(
            rows, n, lits=lits, pids=pids, cap=cap), plain_reps, 1),
        "literal_spans_bound_ms": max(tb, to) * 1e3,
        "literal_spans_bound_by": "bytes" if tb >= to else "operations",
    }
    del rows
    x = torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                      device=DEV)
    res.update({
        "scan1d_ms": time_ms(lambda: sc.rcummin(x), reps),
        "scan1d_cummax_ms": time_ms(lambda: sc.cummax(x), reps),
        "scan1d_plain_ms": time_ms(lambda: sc.rcummin_plain(x), plain_reps,
                                   1),
        "scan1d_cummax_plain_ms": time_ms(lambda: sc.cummax_plain(x),
                                          plain_reps, 1),
        # One PyTorch call of the same work: the forward torch.cummin (no
        # reverse form exists). Slow on the card, so timed as the plain
        # versions are.
        "scan1d_library_ms": time_ms(lambda: torch.cummin(x, 0), plain_reps,
                                     1),
        "scan1d_bound_ms": 8 * n / HBM_BYTES_PER_S * 1e3,
        "scan1d_bound_by": "bytes",
    })
    del x
    if walls:
        engines = {"literal_spans_path": kp}
        for name, (pat, _) in B3_PATTERNS.items():
            engines[name + "_path"] = rt.Pattern(pat, device=DEV)
        for k, p in engines.items():
            w = wall_s(lambda: p.match_all_arrays(text), reps // 2)
            res[k + "_wall"] = w
            res[k + "_GBps"] = n / w["median_s"] / 1e9
            p.match_all_arrays(text)
            res[k + "_device_s"] = p.last_stats.device_time_s
            res[k + "_select_s"] = p.last_stats.select_time_s
    return res


def time_config1(rt, text: bytes, label: str, reps: int) -> dict:
    """Config 1's entry-point walls, from host bytes and from a staged
    corpus, with the device / host split of match_all_arrays."""
    n = len(text)
    p = rt.Pattern(CONFIG1_PATTERN, device=DEV)
    corpus = rt.stage(text, DEV)
    res = {"label": label, "n": n}
    walls = {
        "match_all": wall_s(lambda: p.match_all_arrays(text), reps),
        "match_all_staged": wall_s(lambda: p.match_all_arrays(corpus), reps),
        "match_all_count": wall_s(lambda: p.match_all_count(text), reps),
        "match_all_count_staged": wall_s(lambda: p.match_all_count(corpus),
                                         reps),
        "match_first_staged": wall_s(lambda: p.match_first(corpus), reps),
    }
    for k, w in walls.items():
        res[k + "_wall"] = w
        res[k + "_GBps"] = n / w["median_s"] / 1e9
    for key, src in (("", text), ("staged_", corpus)):
        p.match_all_arrays(src)
        res[key + "match_all_device_s"] = p.last_stats.device_time_s
        res[key + "match_all_select_s"] = p.last_stats.select_time_s
    res["matches"] = p.last_stats.n_matches
    return res


def planted_words_text(words, size: int, chunk: int) -> bytes:
    """words_text(size) with a word of the set planted across every
    `chunk` edge, a space on either side of it."""
    buf = bytearray(words_text(size))
    rng = np.random.default_rng(17)
    for e in range(chunk, size, chunk):
        w = words[int(rng.integers(len(words)))]
        s = e - len(w) // 2
        buf[s - 1:s + len(w) + 1] = b" " + w + b" "
    return bytes(buf)


def pieces_after_space(text: bytes, most: int) -> list:
    """[lo, hi) pieces of `text` of at most `most` bytes, each cut just
    after a space."""
    out, lo, n = [], 0, len(text)
    while lo < n:
        hi = min(lo + most, n)
        if hi < n:
            hi = text.rindex(b" ", lo, hi) + 1
        out.append((lo, hi))
        lo = hi
    return out


class Stop(Exception):
    pass


def killed_and_resumed(p, text: bytes, state_dir: str, after: int = 5,
                       chunk: int = STREAM_CHUNK):
    """match_all_stream of `text` in `chunk`-byte chunks, killed by its
    progress callback after `after` chunks, then resumed from `state_dir`:
    (result, chunks done before the kill, chunks of the resume)."""
    done, resumed = [], []

    def bomb(i, nc):
        done.append(i)
        if len(done) == after:
            raise Stop()

    try:
        p.match_all_stream(text, chunk_bytes=chunk,
                           state_dir=state_dir, progress=bomb)
        check(False, "the stream was not killed")
    except Stop:
        pass
    out = p.match_all_stream(text, chunk_bytes=chunk,
                             state_dir=state_dir,
                             progress=lambda i, nc: resumed.append(i))
    check(resumed == list(range(done[-1] - 1, -1, -1))
          and not set(resumed) & set(done),
          f"resume: done {done}, resumed {resumed[:3]}...")
    return out, done, resumed


def same_arrays(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def emit_f_at_stream_shapes(p, text: bytes) -> dict:
    """schain_fused with emit_f against its plain version at the shapes the
    stream path gives it on this text, each with a neutral seed and the
    first_start the stream takes at its base: an interior chunk (P = n =
    STREAM_CHUNK at byte STREAM_CHUNK), the last chunk (P = STREAM_CHUNK +
    K, so boundary n is inside), and the ladder's windows at the default
    first window W0 (W0 at byte 0, W0 at byte W0 after a window with no
    match, 2 W0 at byte 0 after an inconclusive one). L, I, G and F on
    0..n in both modes, both instances, the skip on and off; F past n
    apart."""
    from rejit_tpu_torch.engine import stream

    src = np.frombuffer(text, np.uint8)
    K_, W0 = p.fused_block, p.config.first_window
    shapes = (("interior_chunk", STREAM_CHUNK, STREAM_CHUNK, STREAM_CHUNK),
              ("last_chunk", len(text) - STREAM_CHUNK, STREAM_CHUNK,
               STREAM_CHUNK + K_),
              ("window_0", 0, W0, W0), ("window_at_W0", W0, W0, W0),
              ("window_doubled", 0, 2 * W0, 2 * W0))
    err, cases = 0, {}
    for name, a, n, P in shapes:
        buf = np.zeros(P, np.uint8)
        buf[:n] = src[a:a + n]
        fs = stream._first_start_at(p.tables, src, a)
        e = fused_vs_plain(p.ct, torch.from_numpy(buf).to(DEV), (n,),
                           modes=("l", "li"), seeds=("neutral",), block=K_,
                           emit_f=True, first_starts=(fs,))
        err = max(err, e["max_abs_err"], e["f_past_n_err"])
        cases[name] = {"base": a, "n": n, "P": P, "first_start": fs,
                       "calls": e["calls"], "max_abs_err": e["max_abs_err"],
                       "f_past_n_err": e["f_past_n_err"]}
    return {"max_abs_err": err, "cases": cases}


def time_emit_f(ct, text: bytes, reps: int, plain_reps: int) -> dict:
    """schain_fused in L mode and with emit_f on one text (a neutral seed,
    the stream's call), by CUDA events, the emit_f plain version, and the
    byte bound of emit_f: 1 B of text in, 4 B of L and 1 B of F out a
    byte, the table once."""
    from rejit_tpu_torch.kernels import schain_cuda as sc

    t = padded(text, DEV)
    n, P, Q = len(text), t.shape[0], ct.n_states
    seed = sc.neutral_seed(Q, t.device)
    out = {}
    for name, kw in (("l", {}), ("emit_f", {"emit_f": True}),
                     ("l_again", {})):
        out[name + "_ms"] = time_ms(
            lambda: sc.schain_fused(ct, t, n, seed, block=K, mode="l", **kw),
            reps)
    if plain_reps:
        out["emit_f_plain_ms"] = time_ms(
            lambda: sc.schain_fused_plain(ct, t, n, seed, block=K, mode="l",
                                          emit_f=True), plain_reps, warmup=1)
    b = bound(P + Q * ct.n_classes * 4 + 5 * P, ALU_OPS_PER_STEP * n * Q)
    out.update({"emit_f_" + k: v for k, v in b.items()})
    return out


def stream_phase(rt, p, wp, words, quick: bool, reset, launches,
                 only) -> dict:
    """The stream path on the card: (b) config 3 on the fused route and
    (c) the 250-word set on the split route, 256 MiB each in 8 MiB chunks,
    killed and resumed; (d) the early exit; (e) no retries; (f) times.
    Returns the kernels-line numbers of schain_fused_emit_f."""
    import shutil
    import tempfile

    from rejit_tpu_torch.engine import stream
    from rejit_tpu_torch.kernels import schain_cuda as sc
    from rejit_tpu_torch.utils.corpus import make_corpus

    row = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    try:
        # (b) Config 3 on the fused route.
        text = make_corpus(STREAM_SIZE, seed=2, needle=b"matching",
                           density=0.01)
        nc = -(-len(text) // STREAM_CHUNK)
        # (a) emit_f at the stream's own chunk and window shapes.
        e = emit_f_at_stream_shapes(p, text)
        emit({"phase": "fused_emit_f_vs_plain", "shapes": "stream path",
              "pattern": MAIN_PATTERN.decode(), "Q": p.ct.n_states, **e})
        row["max_abs_err"] = e["max_abs_err"]
        reset()
        out, done, resumed = killed_and_resumed(p, text,
                                                os.path.join(tmp, "b"))
        got = launches()
        check(only(got, schain_fused=nc), f"config-3 stream: {got}")
        row["launches"] = got["schain_fused"]
        ref = p.match_all_arrays(text)
        check(same_arrays(out, ref), "config-3 stream differs from "
              "match_all_arrays")
        emit({"phase": "stream_fused", "pattern": MAIN_PATTERN.decode(),
              "n": len(text), "chunk_bytes": STREAM_CHUNK, "chunks": nc,
              "killed_after": done, "resumed_chunks": len(resumed),
              "matches": len(out[0]), "launches": got,
              "equal_to_match_all_arrays": True})
        # (d) The early exit, on the same text.
        reset()
        m = p.match_first(text)
        got = launches()
        check(m == (int(ref[0][0]), int(ref[1][0])), f"match_first {m}")
        check(1 <= got["schain_fused"] <= 4
              and only(got, schain_fused=got["schain_fused"]),
              f"match_first launches: {got}")
        first_launches = got["schain_fused"]
        corpus = rt.stage(text, DEV)
        corpus.padded(p.fused_block)
        uploads = corpus.uploads
        check(p.match_first(corpus) == m and p.match_anywhere(corpus)
              and p.match_anywhere(text), "staged early exit")
        check(corpus.uploads == uploads, "the staged ladder uploaded")
        nq = rt.Pattern(rb"qu[0-9]+z", rt.Config(engine="dfa"), device=DEV)
        check(nq.fused and len(nq.match_all_arrays(text)[0]) == 0,
              "qu[0-9]+z matches the config-3 text")
        check(nq.match_first(text) is None and not nq.match_anywhere(text)
              and nq.match_first(corpus) is None
              and not nq.match_anywhere(corpus), "no-match ladder")
        for pat, small in ((p, b"singing"), (p, text[:1 << 20]),
                           (wp, words[0]), (wp, text[:1 << 16])):
            check(pat.match_full_stream(small, chunk_bytes=1 << 16)
                  == pat.match_full(small), "match_full_stream")
        emit({"phase": "stream_early_exit", "n": len(text),
              "match_first": m, "launches": first_launches,
              "staged_uploads": corpus.uploads,
              "match_full_stream_equal": True})
        del corpus
        if not quick:
            tf = time_emit_f(p.ct, text[:STREAM_CHUNK], reps=20,
                             plain_reps=2)
            t256 = time_emit_f(p.ct, text, reps=5, plain_reps=0)
            whole = rt.Pattern(MAIN_PATTERN, rt.Config(first_window=1 << 62),
                               device=DEV)
            row.update(ms=tf["emit_f_ms"], plain_ms=tf["emit_f_plain_ms"],
                       bound_ms=tf["emit_f_bound_ms"],
                       bound_by=tf["emit_f_bound_by"])
            dirs = iter(range(1 << 20))
            walls = {
                "stream": wall_s(lambda: p.match_all_stream(
                    text, chunk_bytes=STREAM_CHUNK), 3),
                "stream_state_dir": wall_s(lambda: p.match_all_stream(
                    text, chunk_bytes=STREAM_CHUNK, state_dir=os.path.join(
                        tmp, f"bw{next(dirs)}")), 3),
                "match_all_arrays": wall_s(lambda: p.match_all_arrays(text),
                                           3),
                "match_first": wall_s(lambda: p.match_first(text), 5),
                "match_first_full_scan": wall_s(
                    lambda: whole.match_first(text), 3),
            }
            emit({"phase": "times_stream_fused", "n": len(text),
                  "emit_f_8MiB": tf, "emit_f_256MiB": t256, "walls": walls,
                  "gb_per_s": {k: len(text) / v["median_s"] / 1e9
                               for k, v in walls.items()}})
        del text, out, ref

        # (c) The 250-word set (Q = 871) on the split route.
        check(not wp.fused, "250-word set on the fused route")
        text = planted_words_text(words, STREAM_SIZE, STREAM_CHUNK)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset()
        out, done, resumed = killed_and_resumed(wp, text,
                                                os.path.join(tmp, "c"))
        got = launches()
        peak = torch.cuda.max_memory_allocated() - base
        check(only(got, dfa_phase1=nc, dfa_phase3=nc),
              f"250-word stream: {got}")
        starts, ends = [], []
        for lo, hi in pieces_after_space(text, STREAM_CHUNK):
            s_, e_, _ = wp.match_all_arrays(text[lo:hi])
            starts.append(s_ + lo)
            ends.append(e_ + lo)
        want = (np.concatenate(starts), np.concatenate(ends))
        check(same_arrays(out[:2], want), "250-word stream differs from "
              "the pieces' match_all_arrays")
        spans = set(zip(out[0].tolist(), out[1].tolist()))
        crossing = sum(any((e - d, e - d + len(w)) in spans
                           for w in words for d in range(1, len(w)))
                       for e in range(STREAM_CHUNK, len(text), STREAM_CHUNK))
        check(crossing == nc - 1, f"{crossing} spans cross chunk edges")
        emit({"phase": "stream_split", "patterns": "250-word alternation",
              "Q": wp.ct.n_states, "n": len(text), "chunks": nc,
              "killed_after": done, "resumed_chunks": len(resumed),
              "matches": len(out[0]), "spans_across_chunk_edges": crossing,
              "launches": got, "peak_device_bytes": peak,
              "equal_to_pieces": True})
        if not quick:
            dirs = iter(range(1 << 20))
            walls = {
                "stream": wall_s(lambda: wp.match_all_stream(
                    text, chunk_bytes=STREAM_CHUNK), 3, warm=False),
                "stream_state_dir": wall_s(lambda: wp.match_all_stream(
                    text, chunk_bytes=STREAM_CHUNK, state_dir=os.path.join(
                        tmp, f"cw{next(dirs)}")), 3, warm=False),
            }
            emit({"phase": "times_stream_split", "n": len(text),
                  "walls": walls,
                  "gb_per_s": {k: len(text) / v["median_s"] / 1e9
                               for k, v in walls.items()}})
        del text, out
        # (e) No chunk was retried.
        check(stream.RETRIES == 0, f"stream retries: {stream.RETRIES}")
        check(sc.MAX_P >= STREAM_CHUNK, "chunk above the kernel's limit")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return row


def probe_sass() -> dict:
    """Opcode counts of the gather_probe kernels' SASS at the default U = 8
    (cuobjdump -sass on the built library): the serial kernel's lookups
    are shared-memory loads (LDS) in its loop, not hoisted out of it; the
    select kernel compares and selects (ISETP, SEL) and reads no table
    (no LDS)."""
    from rejit_tpu_torch.kernels import build

    _, lib, _ = build._paths("gather_probe")
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out = {}
    for name, sel in (("serial", "false"), ("select", "true")):
        # Functions are listed by their mangled names: the U = 8 instance
        # is ...ILi8ELb0E... (serial) or ...ILi8ELb1E... (select).
        tag = f"ILi8ELb{int(sel == 'true')}E"
        body, on = [], False
        for line in sass.splitlines():
            if "Function :" in line:
                on = tag in line
            elif on:
                body.append(line)
        ops = {}
        for line in body:
            m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                          line)
            if m:
                op = m.group(1).split(".")[0]
                ops[op] = ops.get(op, 0) + 1
        out[name] = {k: ops.get(k, 0) for k in
                     ("LDS", "LDG", "LDC", "STS", "ISETP", "SEL", "LEA",
                      "IMAD", "BRA")}
        out[name]["instructions"] = sum(ops.values())
    return out


def gather_probe_phase(reset, launches, quick: bool) -> dict:
    """The gather probe on the card: the kernel held bit-equal to its
    plain version in both modes (n = 0 and 1, U = 1 and 8, QS = 8, 32 and
    128, one block and one per SM, and at the script's defaults); the
    probe's path (`probes.gather_probe.measure`, both modes at the
    defaults on one block and on every SM's resident blocks) with its
    launch count; the ratio of the two rates and the Q at which one
    lookup step costs a Q-term select chain; the SASS. Returns the
    kernels-line row."""
    from rejit_tpu_torch.kernels import probe_cuda as pc
    from rejit_tpu_torch.probes import gather_probe as gp

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    err, calls = 0, 0
    for mode, qss in (("serial", (0,)), ("select", (8, 32, 128))):
        for qs in qss:
            for u in (1, 8):
                t, y = gp.inputs(u, DEV)
                for n in (0, 1):
                    want = pc.gather_chain_plain(
                        t, y, n, iters=PROBE_CHECK_ITERS, mode=mode, qs=qs)
                    for replicas in (1, sms):
                        got = pc.gather_chain(
                            t, y, n, iters=PROBE_CHECK_ITERS, mode=mode,
                            qs=qs, replicas=replicas)
                        err = max(err, max_abs_err(
                            got, want.expand(replicas, -1, -1)))
                        calls += 1
    d = PROBE_DEFAULTS
    t, y = gp.inputs(d["u"], DEV)
    for mode in ("serial", "select"):
        want = pc.gather_chain_plain(t, y, 1, iters=d["iters"], mode=mode,
                                     qs=d["qs"])
        got = pc.gather_chain(t, y, 1, iters=d["iters"], mode=mode,
                              qs=d["qs"], replicas=sms)
        err = max(err, max_abs_err(got, want.expand(sms, -1, -1)))
        calls += 1
    emit({"phase": "gather_probe_vs_plain", "calls": calls,
          "max_abs_err": err, "sms": sms})
    check(err == 0, "gather_probe differs from its plain version")
    try:
        sass = probe_sass()
    except Exception as exc:  # the listing only; no result depends on it
        sass = {"error": repr(exc)}
    emit({"phase": "gather_probe_sass", "u": 8, **sass})

    # The probe's path, as `python -m rejit_tpu_torch.probes.gather_probe`
    # runs it, with its own launch count.
    iters = 64 if quick else d["iters"]
    reset()
    rows = {}
    for mode in ("serial", "select"):
        for where, replicas in (("one_block", 1), ("card", 0)):
            rows[mode + "_" + where] = gp.measure(
                mode=mode, u=d["u"], iters=iters, qs=d["qs"],
                replicas=replicas, device=DEV)
    n_launches = launches()["gather_probe"]
    check(n_launches > 0, "the probe path launched no gather_probe")
    res = {"phase": "gather_probe", "iters": iters, "rows": rows,
           "launches": n_launches}
    for where in ("one_block", "card"):
        ratio = (rows["serial_" + where]["lookups_per_sec"]
                 / rows["select_" + where]["select_rows_per_sec"])
        res["lookup_over_select_row_" + where] = ratio
        res["break_even_q_" + where] = 1 / ratio
    card = rows["serial_card"]
    lookups = d["u"] * iters * card["replicas"] * 1024
    sel = rows["select_card"]
    sel_ops = 2 * d["u"] * iters * d["qs"] * sel["replicas"] * 1024
    res["serial_bound_ms"] = lookups / SMEM_LOADS_PER_S * 1e3
    res["select_bound_ms"] = sel_ops / PEAK_LANE_OPS_PER_S * 1e3
    # The serial bound for the probe's own inputs: a warp's lookup takes
    # as many shared-memory wavefronts as its busiest bank has distinct
    # addresses, counted exactly along the chains. The compares and
    # selects issue on an SM's 64 int32 lanes if not on all 128: the
    # select bound on 64 lanes beside the 128-lane one.
    waves = gp.busiest_bank_wavefronts(d["u"], iters)
    res["serial_wavefronts_per_lookup"] = waves
    res["serial_bound_probe_inputs_ms"] = res["serial_bound_ms"] * waves
    res["select_bound_64_lanes_ms"] = 2 * res["select_bound_ms"]
    if not quick:
        # The same serial chain with identity table rows and each chain at
        # its lane's own index: a warp's 32 loads hit 32 banks. Against
        # the random permutation (`serial_wavefronts_per_lookup` on the
        # busiest bank of a warp), this reads what bank conflicts cost a
        # lookup.
        ident = torch.arange(128, dtype=torch.int32, device=DEV).repeat(
            8 * d["u"], 1)
        ti = ident[:8].contiguous()
        for where, replicas in (("one_block", 1), ("card", card["replicas"])):
            sec = gp.seconds_per_call(lambda: pc.gather_chain(
                ti, ident, 0, iters=iters, mode="serial", qs=0,
                replicas=replicas), DEV)
            res["conflict_free_lookups_per_sec_" + where] = (
                d["u"] * iters * replicas * 1024 / sec)
    row = {"launches": n_launches, "max_abs_err": err}
    if not quick:
        row.update(
            ms=card["sec_per_call"] * 1e3,
            plain_ms=time_ms(lambda: pc.gather_chain_plain(
                t, y, 0, iters=d["iters"], mode="serial", qs=d["qs"],
                replicas=card["replicas"]), 1, 1),
            bound_ms=res["serial_bound_ms"], bound_by="operations")
        res["select_ms"] = sel["sec_per_call"] * 1e3
        res["serial_plain_ms"] = row["plain_ms"]
        for key in ("serial_bound_ms", "serial_bound_probe_inputs_ms"):
            res[key.replace("bound", "share_of_bound")] = (
                res[key] / row["ms"])
        for key in ("select_bound_ms", "select_bound_64_lanes_ms"):
            res[key.replace("bound", "share_of_bound")] = (
                res[key] / res["select_ms"])
    emit(res)
    return row


def posnfa_text(size: int) -> bytes:
    return np.random.default_rng(7).choice(
        np.frombuffer(b"aabbx", np.uint8), size=size).tobytes()


def posnfa_phase(rt, reset, launches, only, quick: bool) -> dict:
    """The DFA-blowup fallback chain on the card: (a|b)*a(a|b){14} under
    the default Config must land on the posnfa engine with the reference's
    warning and run the 10 MB text of the JAX package's posnfa workload
    (five 2 MiB chunks of the exact sweep) equal to `re`, to the port's
    CPU run and to the oracle on a prefix; every entry point and the
    stream killed after 2 chunks and resumed; the W = 3 pattern beside it;
    the oracle route on a small text. Outside --quick: walls, per-chunk
    device ms, peak memory and the byte bound. Returns what the profiler
    reads at the end (the pattern and a chunk)."""
    import shutil
    import tempfile
    import warnings

    from rejit_tpu_torch.engine import nfaset

    text = posnfa_text(POSNFA_SIZE)
    res = {}
    chunk = POSNFA_CHUNK
    tmp = tempfile.mkdtemp(prefix="chip_smoke_posnfa_")
    try:
        for label, pat in (("W1", POSNFA_PATTERN), ("W3", POSNFA_W3_PATTERN)):
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                p = rt.Pattern(pat, device=DEV)
            check(p.engine == "posnfa" and any(
                "position-NFA" in str(x.message) for x in w),
                f"{pat!r}: engine {p.engine}, warnings {len(w)}")
            pt = p._posnfa
            K = p._posnfa_block()
            reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = p.match_all_arrays(text)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            got = launches()
            check(only(got), f"posnfa launched a CUDA kernel: {got}")
            check(p.last_stats.engine == "posnfa", "posnfa stats")
            want = re_spans(pat, text)
            check(spans_of(out) == want, f"{label}: spans differ from re")
            pre = text[:POSNFA_CHECK]
            pre_out = p.match_all_arrays(pre)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                cpu = rt.Pattern(pat, device="cpu")
            check(cpu.engine == "posnfa" and same_arrays(
                cpu.match_all_arrays(pre), pre_out), f"{label}: CPU run")
            orc = rt.Pattern(pat, rt.Config(engine="oracle"), device=DEV)
            check(orc.tokenize(pre) == p.tokenize(pre), f"{label}: oracle")
            r = {"pattern": pat.decode(), "Q": pt.Q, "W": pt.W, "F": pt.F,
                 "K": K, "n": len(text), "matches": len(want),
                 "launches": got, "peak_device_bytes": peak,
                 "equal_to_re": True, "prefix": len(pre),
                 "prefix_matches": len(pre_out[0]),
                 "prefix_equal_to_cpu_and_oracle": True}
            if label == "W1":
                m = p.match_first(text)
                check(m == (int(out[0][0]), int(out[1][0])), "match_first")
                check(not p.match_full(text) and p.match_anywhere(text),
                      "match_full / match_anywhere")
                full = p.match_full(b"ab" * 8)
                check(full == bool(re.fullmatch(pat, b"ab" * 8)),
                      "match_full of a match")
                tok = p.tokenize(text)
                check(tok == list(zip(out[0].tolist(), out[1].tolist(),
                                      [0] * len(want))), "tokenize")
                check(p.match_all_count(text) == len(want), "count")
                corpus = rt.stage(text, DEV)
                check(same_arrays(p.match_all_arrays(corpus), out),
                      "staged corpus")
                del corpus
                reset()
                sout, done, resumed = killed_and_resumed(
                    p, text, os.path.join(tmp, "w1"), after=2, chunk=chunk)
                check(same_arrays(sout, out), "posnfa stream differs from "
                      "match_all_arrays")
                check(only(launches()), "posnfa stream launched a kernel")
                check(p.match_first_stream(text, chunk_bytes=chunk) == m
                      and p.match_anywhere_stream(text, chunk_bytes=chunk)
                      and not p.match_full_stream(text, chunk_bytes=chunk),
                      "posnfa first/anywhere/full stream")
                r.update(match_first=m, stream_chunks=-(-len(text) // chunk),
                         killed_after=done, resumed_chunks=len(resumed),
                         entry_points_equal=True)
            if not quick:
                head = text[:chunk]
                P = -(-chunk // K) * K
                td = padded(head, DEV, P)
                r["chunk_bytes"] = chunk
                r["chunk_ms"] = time_ms(lambda: nfaset.l_arrays_device_nfaset(
                    pt, td, len(head), block=K), 3, 1)
                r["chunk_bound"] = bound(9 * chunk, 0)
                r["match_all_arrays_wall"] = wall_s(
                    lambda: p.match_all_arrays(text), 3)
                r["gb_per_s"] = (len(text) / r["match_all_arrays_wall"]
                                 ["median_s"] / 1e9)
                r["bound"] = bound(9 * len(text), 0)
            emit({"phase": "posnfa_" + label, **r})
            res[label] = (p, pt, K)
        # The oracle route: a forced engine and a posnfa='off' blowup.
        small = text[:2048]
        want = re_spans(POSNFA_PATTERN, small)
        forced = rt.Pattern(POSNFA_PATTERN, rt.Config(engine="oracle"),
                            device=DEV)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            off = rt.Pattern(POSNFA_PATTERN, rt.Config(posnfa="off"),
                             device=DEV)
        check(forced.engine == off.engine == "oracle" and any(
            "falling back" in str(x.message) for x in w), "oracle route")
        for q in (forced, off):
            check(q.match_all(small) == want, "oracle spans differ from re")
        emit({"phase": "oracle_route", "n": len(small),
              "matches": len(want), "equal_to_re": True})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def posnfa_launches(pt, K: int, chunk: int) -> dict:
    """CUDA kernels and device ms of one l_arrays_device_nfaset call on a
    chunk of the posnfa text, by the profiler (run last)."""
    from torch.profiler import ProfilerActivity, profile

    from rejit_tpu_torch.engine import nfaset

    td = padded(posnfa_text(chunk), DEV, K)
    run = lambda: nfaset.l_arrays_device_nfaset(pt, td, chunk, block=K)
    run()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        kernels, ms, top = 0, 0.0, []
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0)
            if us > 0:
                kernels += e.count
                ms += us / 1e3
                top.append((us / 1e3, e.count, e.key[:60]))
        top.sort(reverse=True)
        return {"device_ops": kernels, "device_ms": ms, "top": top[:8]}
    except Exception as exc:  # the measurement only
        return {"error": repr(exc)}


def regexdna_steps(rt, data: bytes, device, config=None) -> dict:
    """The sample's three steps on `device`: the stripped text, the nine
    counts and the IUB-replaced text, with each step's Pattern."""
    cfg = config or rt.Config()
    strip = rt.Pattern(DNA_STRIP, cfg, device=device)
    stripped = strip.replace(data, b"")
    nine = rt.Pattern(["(?i)" + v for v in DNA_VARIANTS], cfg, device=device)
    counts = nine.match_all_count_each(rt.stage(stripped, device)).tolist()
    iub = rt.Pattern([f"[{c}{c.lower()}]" for c, _ in DNA_IUB], cfg,
                     device=device)
    seq = iub.replace_each(stripped, [r for _, r in DNA_IUB])
    return {"stripped": stripped, "counts": counts, "seq": seq,
            "patterns": (strip, nine, iub)}


def stats_split(st) -> dict:
    """A last_stats' device / selection split, totals and counts."""
    return {"device_s": st.device_time_s, "select_s": st.select_time_s,
            "total_s": st.total_time_s, "candidates": st.n_candidates,
            "matches": st.n_matches, "op": st.op, "engine": st.engine}


def replace_phase(rt, main_text: bytes, reset, launches, only,
                  quick: bool) -> dict:
    """regex-dna at its published size through the port's Replace path:
    strip (`replace`, a DFA on the fused route: schain_fused), the nine
    variant counts on the staged result (`match_all_count_each`, the
    literal engine's torch ops), the IUB pass (`replace_each`, 22
    single-byte literals: literal_spans). Each step's launches, its output
    held byte for byte against Python `re`, a 1 MB prefix against the
    port's CPU run and `Config(selection='python')` on the card;
    replace_first and split (with and without maxsplit) on config 3's
    10 MB text against `re`. The strip's schain_fused and the IUB pass's
    literal_spans are held against their plain versions at the shapes
    this path gives them. Outside --quick each step's wall (median of 3)
    with its last_stats split. Returns the launches and the kernels'
    max_abs_err, by kernel."""
    from rejit_tpu_torch.kernels import extract_cuda as xc
    from rejit_tpu_torch.native import build as nbuild
    from rejit_tpu_torch.native import lib as nlib
    from rejit_tpu_torch.utils.corpus import make_fasta

    t0 = time.perf_counter()
    nlib.load()   # raises if the native helpers do not build
    native_s = time.perf_counter() - t0
    data = make_fasta(DNA_BASES)
    res = {"bases": DNA_BASES, "input_bytes": len(data),
           "native_library": os.path.basename(nbuild.lib_path()),
           "native_load_s": native_s}
    strip = rt.Pattern(DNA_STRIP, device=DEV)
    check(strip.engine == "dfa" and strip.fused and strip._use_native(),
          "strip pattern: not the fused route with the native helpers")
    reset()
    stripped = strip.replace(data, b"")
    steps = {"strip": {"launches": launches(),
                       "stats": stats_split(strip.last_stats)}}
    staged = rt.stage(stripped, DEV)
    nine = rt.Pattern(["(?i)" + v for v in DNA_VARIANTS], device=DEV)
    reset()
    counts = nine.match_all_count_each(staged).tolist()
    steps["counts"] = {"launches": launches(),
                       "stats": stats_split(nine.last_stats)}
    iub = rt.Pattern([f"[{c}{c.lower()}]" for c, _ in DNA_IUB], device=DEV)
    check(iub.engine == "literal" and not iub._bitmask_ok()
          and iub._spans_kernel_ok(None), "IUB pattern: not literal_spans")
    reps = [r for _, r in DNA_IUB]
    reset()
    seq = iub.replace_each(stripped, reps)
    steps["iub"] = {"launches": launches(),
                    "stats": stats_split(iub.last_stats)}
    ls = steps["strip"]["launches"]["schain_fused"]
    li = steps["iub"]["launches"]["literal_spans"]
    check(ls >= 1 and only(steps["strip"]["launches"], schain_fused=ls),
          f"strip launches: {steps['strip']['launches']}")
    check(only(steps["counts"]["launches"]),
          f"counts launches: {steps['counts']['launches']}")
    check(li >= 1 and only(steps["iub"]["launches"], literal_spans=li),
          f"IUB launches: {steps['iub']['launches']}")
    # Python re, byte for byte.
    want_strip = re.sub(DNA_STRIP, b"", data)
    check(stripped == want_strip, "stripped text differs from re.sub")
    want_counts = [len(re.findall(v.encode(), stripped, re.I))
                   for v in DNA_VARIANTS]
    check(counts == want_counts, f"counts {counts} != re {want_counts}")
    want_seq = stripped
    for c, r in DNA_IUB:
        want_seq = re.sub(f"[{c}{c.lower()}]".encode(), r, want_seq)
    check(seq == want_seq, "IUB text differs from re.sub")
    del want_strip, want_seq
    res.update(lengths=[len(data), len(stripped), len(seq)],
               counts=dict(zip(DNA_VARIANTS, counts)), equal_to_re=True)
    # The two kernels at this path's shapes, against their plain versions:
    # the strip's padded 50.8 MB text and tables (one pattern: mode 'l',
    # the solo seed), and the stripped text's rows with the IUB literals
    # at the caps the path took (4, then 4·2^k up to the busiest row).
    check(strip.ct.n_patterns == 1, "strip pattern: more than one pid")
    u8 = np.frombuffer(data, np.uint8)
    fe = fused_vs_plain(strip.ct,
                        strip._padded_text(u8, None, strip.fused_block),
                        (len(data),), modes=("l",), seeds=("solo",),
                        block=strip.fused_block)
    del u8
    sets = [(iub.info.literals, iub.info.literal_pids)]
    ml = max(len(x) for x in iub.info.literals)
    s8 = np.frombuffer(stripped, np.uint8)
    le = literal_spans_vs_plain(xc, s8, sets, caps=(0, 4), max_len=ml)
    cap = 4
    while cap < le["max_row_count"]:
        cap *= 2
    check(li == 1 + (cap > 4), f"IUB pass: {li} launches for cap {cap}")
    le2 = literal_spans_vs_plain(xc, s8, sets, caps=(cap,), max_len=ml)
    del s8
    errs = {"schain_fused": fe["max_abs_err"],
            "literal_spans": max(le["max_abs_err"], le2["max_abs_err"])}
    res["kernels_vs_plain"] = {
        "schain_fused": {k: fe[k] for k in ("max_abs_err", "calls",
                                            "instances")},
        "literal_spans": {"max_abs_err": errs["literal_spans"],
                          "calls": le["calls"] + le2["calls"],
                          "P": le["P"], "caps": le["caps"] + le2["caps"],
                          "max_row_count": le["max_row_count"]}}
    # A prefix: the card, the port's CPU run and selection='python' agree.
    pre = data[:DNA_CHECK]
    card = regexdna_steps(rt, pre, DEV)
    for other in (regexdna_steps(rt, pre, "cpu"),
                  regexdna_steps(rt, pre, DEV, rt.Config(selection="python"))):
        check(all(card[k] == other[k] for k in ("stripped", "counts", "seq")),
              "regex-dna prefix: card, CPU and selection='python' differ")
    res["prefix"] = {"bytes": len(pre), "counts": card["counts"],
                     "equal_to_cpu_and_python_selection": True}
    # replace_first and split on config 3's 10 MB text.
    p = rt.Pattern(MAIN_PATTERN, device=DEV)
    check(p.replace_first(main_text, b"X") == re.sub(
        MAIN_PATTERN, b"X", main_text, count=1), "replace_first differs")
    for ms in (0, 5):
        parts = p.split(main_text, maxsplit=ms)
        check(parts == re.split(MAIN_PATTERN, main_text, maxsplit=ms),
              f"split(maxsplit={ms}) differs from re.split")
    res["config3_replace_first_and_split_equal_to_re"] = True
    res["config3_split_pieces"] = len(p.split(main_text))
    if not quick:
        walls = {
            "strip": (strip, lambda: strip.replace(data, b"")),
            "counts": (nine, lambda: nine.match_all_count_each(staged)),
            "iub": (iub, lambda: iub.replace_each(stripped, reps)),
        }
        for step, (pat, fn) in walls.items():
            steps[step]["wall"] = wall_s(fn, 3)
            steps[step]["stats_last_call"] = stats_split(pat.last_stats)
        res["all_three_wall_s"] = sum(steps[k]["wall"]["median_s"]
                                      for k in walls)
        res["input_bytes_per_s"] = len(data) / res["all_three_wall_s"]
        py = rt.Pattern(DNA_STRIP, rt.Config(selection="python"),
                        device=DEV)
        steps["strip_python_selection"] = {
            "wall": wall_s(lambda: py.replace(data, b""), 3),
            "stats": stats_split(py.last_stats)}
    res["steps"] = steps
    emit({"phase": "replace", **res})
    checked = {"counts": res["counts"], "lengths": res["lengths"]}
    return {"schain_fused": ls, "literal_spans": li}, errs, checked


def select_phase(rt, reset, launches, only, quick: bool) -> dict:
    """Device-side selection (Config(device_select_threshold=0): pointer
    doubling, engine/select_device.py) against the host walk (the default:
    the native greedy) for a class run and an overlapping DFA over config
    3 at 10 MB and 256 MiB, from host bytes and staged: equal arrays,
    equal to `re` at 10 MB; the wall, select_time_s, candidates, cap
    bucket, doubling rounds and peak device memory of each. Every call
    launches its engine's kernel once (scan1d for the class run,
    schain_fused for the DFA) and nothing else: the doubling is torch
    ops. Returns the launches of the first call of each case, by
    kernel."""
    from rejit_tpu_torch.engine import select_device as sd
    from rejit_tpu_torch.utils.corpus import make_corpus

    sizes = SELECT_SIZES[:1] if quick else SELECT_SIZES
    total = {}
    for size in sizes:
        text = make_corpus(size, seed=2, needle=b"matching", density=0.01)
        corpus = rt.stage(text, DEV)
        for name, pat in SELECT_PATTERNS.items():
            host = rt.Pattern(pat, device=DEV)
            dev = rt.Pattern(pat, rt.Config(device_select_threshold=0),
                             device=DEV)
            check(host.engine == dev.engine == name, f"{pat!r} engine")
            want = re_spans(pat, text) if size <= 10_000_000 else None
            row = {"pattern": pat.decode(), "engine": name, "n": size}
            outs = {}
            for src, arg in (("host_bytes", text), ("staged", corpus)):
                for label, p in (("host_select", host),
                                 ("device_select", dev)):
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    reset()
                    out = p.match_all_arrays(arg)
                    torch.cuda.synchronize()
                    st = p.last_stats
                    got = launches()
                    check(only(got, **{SELECT_KERNEL[name]: 1}),
                          f"{pat!r} at {size}, {src}, {label}: {got}")
                    for k, v in got.items():
                        total[k] = total.get(k, 0) + v
                    r = {**stats_split(st), "launches": got,
                         "peak_device_bytes":
                             torch.cuda.max_memory_allocated() - base}
                    if label == "device_select":
                        cap = sd._bucket(st.n_candidates)
                        r.update(cap=cap, rounds=sd._rounds(cap))
                    if not quick:
                        r["wall"] = wall_s(lambda: p.match_all_arrays(arg),
                                           3)
                        r["select_s_last_call"] = p.last_stats.select_time_s
                    row[f"{src}_{label}"] = r
                    outs[(src, label)] = out
            first = outs[("host_bytes", "host_select")]
            check(all(same_arrays(o, first) for o in outs.values()),
                  f"{pat!r} at {size}: device and host selection differ")
            if want is not None:
                check(spans_of(first) == want, f"{pat!r}: spans differ "
                      "from re")
            row.update(matches=len(first[0]), equal=True,
                       equal_to_re=want is not None)
            emit({"phase": "select", **row})
        del corpus, text
    return total


class Recorder:
    """Records the calls a path makes to kernel wrappers (module
    attributes, `targets` of (module, name)) and passes them through: the
    path's own inputs, to hold each kernel against its plain version on
    them after."""

    def __init__(self, targets):
        self.targets = targets
        self.calls = []
        self._saved = []

    def __enter__(self):
        for mod, name in self.targets:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))

            def wrapper(*args, _fn=fn, _name=name, **kw):
                self.calls.append((_name, args, kw))
                return _fn(*args, **kw)
            setattr(mod, name, wrapper)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False


def recorded_vs_plain(calls) -> dict:
    """Max |kernel - plain| of each recorded wrapper call, re-run on the
    same CUDA tensors: schain_fused (emit_f; L, I, G and F on every
    boundary) with the FF skip on and off, and the tiles it skipped;
    dfa_phase1 and dfa_phase3 with the path's first_start."""
    from rejit_tpu_torch.kernels import dfa_cuda as dc
    from rejit_tpu_torch.kernels import schain_cuda as sc

    err = {"schain_fused_emit_f": 0, "dfa_phase1": 0, "dfa_phase3": 0}
    skipped = tiles = 0
    for name, args, kw in calls:
        if name == "schain_fused":
            kw = {k: v for k, v in kw.items() if k not in ("use_ff", "stats")}
            check(kw.get("emit_f"), "a sharded schain_fused call without F")
            want = sc.schain_fused_plain(*args, **kw)
            for use_ff in (True, False):
                st = {}
                got = sc.schain_fused(*args, use_ff=use_ff, stats=st, **kw)
                err["schain_fused_emit_f"] = max(err["schain_fused_emit_f"],
                                                 max_abs_err(got, want))
                if use_ff:
                    skipped += int(st["skipped_tiles"])
                    tiles += st["tiles"]
        elif name == "phase1":
            err["dfa_phase1"] = max(err["dfa_phase1"], max_abs_err(
                dc.phase1(*args, **kw), dc.phase1_plain(*args, **kw)))
        else:
            err["dfa_phase3"] = max(err["dfa_phase3"], max_abs_err(
                dc.phase3(*args, **kw), dc.phase3_plain(*args, **kw)))
    torch.cuda.synchronize()
    return {"max_abs_err": err, "calls": len(calls), "tiles": tiles,
            "skipped_tiles": skipped}


def start_mesh_workers(root: str) -> list:
    """The two-process gloo worker (four shards a rank on cuda:0) and a
    one-rank NCCL group (eight shards), started in the background:
    [(label, rank, Popen)]."""
    import socket

    def port() -> int:
        with socket.socket() as s_:
            s_.bind(("localhost", 0))
            return s_.getsockname()[1]

    runs = (("gloo", 2, ["--backend", "gloo", "--shards", "4"]),
            ("nccl", 1, ["--backend", "nccl", "--shards", "8"]))
    procs = []
    for label, world, extra in runs:
        env = dict(os.environ, PYTHONPATH=root, MASTER_ADDR="localhost",
                   MASTER_PORT=str(port()), WORLD_SIZE=str(world))
        for rank in range(world):
            procs.append((label, rank, subprocess.Popen(
                [sys.executable, "-m", "rejit_tpu_torch.dist.multiproc_worker",
                 "--device", "cuda", *extra], cwd=root,
                env=dict(env, RANK=str(rank)), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
    return procs


def finish_mesh_workers(procs) -> dict:
    """Wait for the workers (killing any left at the timeout); each must
    exit 0 and print its MULTIPROC OK line."""
    res = {}
    try:
        for label, rank, pr in procs:
            out, err = pr.communicate(timeout=MESH_WORKER_TIMEOUT_S)
            ok = [ln for ln in out.splitlines()
                  if ln.startswith(f"MULTIPROC OK {rank} ")]
            check(pr.returncode == 0 and len(ok) == 1,
                  f"{label} worker rank {rank}: rc {pr.returncode}, "
                  f"{out[-500:]!r} {err[-2000:]!r}")
            res[f"{label}_rank{rank}"] = ok[0]
    finally:
        for _, _, pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    return res


def mesh_phase(rt, root: str, main_text: bytes, words, reset, launches,
               only, quick: bool) -> tuple:
    """The mesh= path on cuda:0, D = MESH_D shards and one, each call with
    the launch counts set to 0 just before and read just after: config 3
    (256 MiB, fused sweep; and schain_fused='off', split), config 5 (1 GiB:
    the literal route's spans and psum count through the API, and
    sharded_l_arrays on its DFA tables, fused), config 4's tokenizer and
    the 250-word set (10 MB, split), and a sparse text (the FF skip); each
    equal to the single-device call, and configs 3 and 5 to `re`. The
    kernels are held against their plain versions on the calls the path
    made (recorded). The two-process gloo worker and a one-rank NCCL group
    run beside it. Outside --quick, the walls of the single-device call
    against D = 1 and D = MESH_D. Returns (launches on the mesh path by
    kernel name, max_abs_err by kernel name)."""
    from rejit_tpu_torch.dist import sharded as dsh
    from rejit_tpu_torch.dist.mesh import make_mesh
    from rejit_tpu_torch.kernels import dfa_cuda as dc
    from rejit_tpu_torch.kernels import schain_cuda as sc
    from rejit_tpu_torch.utils.corpus import make_corpus

    workers = start_mesh_workers(root)
    meshes = {1: make_mesh([DEV]), MESH_D: make_mesh([DEV] * MESH_D)}
    m8 = meshes[MESH_D]
    check(m8.size == MESH_D and m8.devices[0] == m8.devices[-1], f"{m8}")
    total, errs, skips = {}, {}, {}
    targets = ((sc, "schain_fused"), (dc, "phase1"), (dc, "phase3"))

    def drive(label, fn, **want):
        """fn() with the counts at 0 just before; exactly `want`."""
        reset()
        out = fn()
        got = launches()
        check(only(got, **want), f"mesh {label}: launches {got}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        return out

    def held(label, calls):
        e = recorded_vs_plain(calls)
        emit({"phase": "mesh_kernels_vs_plain", "path": label, **e})
        for k, v in e["max_abs_err"].items():
            errs[k] = max(errs.get(k, 0), v)
        skips[label] = e["skipped_tiles"]

    try:
        # Config 3 at 256 MiB: the fused sweep, D schain_fused (emit_f) a
        # call; schain_fused='off': D dfa_phase1 and D dfa_phase3.
        c3 = make_corpus(MESH_CONFIG3_SIZE, seed=2, needle=b"matching",
                         density=0.01)
        p3 = rt.Pattern(MAIN_PATTERN, device=DEV)
        check(p3.fused and p3._sharded_kw(m8)["engine"] == "fused",
              "config 3 not on the sharded fused route")
        single = p3.match_all_arrays(c3)
        check(spans_of(single) == re_spans(MAIN_PATTERN, c3),
              "config 3: single-device spans differ from re")
        row = {"n": len(c3), "matches": len(single[0])}
        for D, m in meshes.items():
            out = drive(f"config 3 D={D}",
                        lambda: p3.match_all_arrays(c3, mesh=m),
                        schain_fused=D)
            check(same_arrays(out, single), f"config 3 D={D} differs")
            cnt = drive(f"config 3 count D={D}",
                        lambda: p3.match_all_count(c3, mesh=m),
                        schain_fused=D)
            check(cnt == len(single[0]), f"config 3 count D={D}: {cnt}")
        with Recorder(targets) as rec:
            p3.match_all_arrays(c3, mesh=m8)
        held("config 3 fused, shards 0, 3 and 7",
             [rec.calls[i] for i in (0, 3, MESH_D - 1)])
        off = rt.Pattern(MAIN_PATTERN, rt.Config(schain_fused="off"),
                         device=DEV)
        check(off._sharded_kw(m8)["engine"] == "split", "off: route")
        for D, m in meshes.items():
            out = drive(f"config 3 off D={D}",
                        lambda: off.match_all_arrays(c3, mesh=m),
                        dfa_phase1=D, dfa_phase3=D)
            check(same_arrays(out, single), f"config 3 off D={D} differs")
        with Recorder(targets) as rec:
            off.match_all_arrays(c3, mesh=m8)
        held("config 3 split, shards 0, 3 and 7",
             [[c for c in rec.calls if c[0] == k][i]
              for k in ("phase1", "phase3") for i in (0, 3, MESH_D - 1)])
        emit({"phase": "mesh_config3", **row, "shards": list(meshes),
              "equal_to_single_device": True, "equal_to_re": True})
        # The workers end before any wall is timed.
        emit({"phase": "mesh_workers", **finish_mesh_workers(workers)})
        walls = {}
        if not quick:
            walls["config3_256MiB"] = {
                "single": wall_s(lambda: p3.match_all_arrays(c3), 3),
                **{f"D{D}": wall_s(lambda: p3.match_all_arrays(c3, mesh=m),
                                   3) for D, m in meshes.items()},
                "split_single": wall_s(lambda: off.match_all_arrays(c3), 3),
                **{f"split_D{D}": wall_s(
                    lambda: off.match_all_arrays(c3, mesh=m), 3)
                   for D, m in meshes.items()}}
        del c3, single, out

        # A sparse text: the FF tile skip under the neutral seed.
        sp = sparse_text(MESH_SMALL_SIZE, seed=5)
        out = drive("sparse D=8", lambda: p3.match_all_arrays(sp, mesh=m8),
                    schain_fused=MESH_D)
        check(same_arrays(out, p3.match_all_arrays(sp)), "sparse differs")
        with Recorder(targets) as rec:
            p3.match_all_arrays(sp, mesh=m8)
        held("sparse fused, every shard", rec.calls)
        check(skips["sparse fused, every shard"] > 0,
              "the FF skip was not taken on the sharded sparse text")

        # Config 4: the tokenizer at 10 MB, fused.
        tokp = rt.Pattern(TOKENIZER, device=DEV)
        tok = tokp.tokenize(main_text)
        got = drive("config 4 D=8", lambda: tokp.tokenize(main_text,
                                                          mesh=m8),
                    schain_fused=MESH_D)
        check(got == tok, "config 4: sharded tokens differ")
        with Recorder(targets) as rec:
            tokp.tokenize(main_text, mesh=m8)
        held("config 4 fused, shards 0, 3 and 7",
             [rec.calls[i] for i in (0, 3, MESH_D - 1)])
        emit({"phase": "mesh_config4", "n": len(main_text),
              "tokens": len(tok), "equal_to_single_device": True})
        if not quick:
            # The arrays' walls: tokenize adds the same Python list of
            # ~3.4M tuples to both.
            walls["config4_10MB"] = {
                "single": wall_s(lambda: tokp.match_all_arrays(main_text),
                                 3),
                f"D{MESH_D}": wall_s(lambda: tokp.match_all_arrays(
                    main_text, mesh=m8), 3)}
        del tok, got

        # The 250-word set (Q = 871) at 10 MB: the split route.
        wp = rt.Pattern(b"|".join(words), device=DEV)
        check(wp._sharded_kw(m8)["engine"] == "split", "250-word route")
        wtext = words_text(MESH_SMALL_SIZE)
        wsingle = wp.match_all_arrays(wtext)
        out = drive("250-word D=8", lambda: wp.match_all_arrays(
            wtext, mesh=m8), dfa_phase1=MESH_D, dfa_phase3=MESH_D)
        check(same_arrays(out, wsingle), "250-word: sharded differs")
        with Recorder(targets) as rec:
            wp.match_all_arrays(wtext, mesh=m8)
        held("250-word split, shards 0, 3 and 7",
             [[c for c in rec.calls if c[0] == k][i]
              for k in ("phase1", "phase3") for i in (0, 3, MESH_D - 1)])
        emit({"phase": "mesh_250_words", "Q": wp.ct.n_states,
              "n": len(wtext), "matches": len(wsingle[0]),
              "equal_to_single_device": True})
        if not quick:
            walls["words250_10MB"] = {
                "single": wall_s(lambda: wp.match_all_arrays(wtext), 3),
                f"D{MESH_D}": wall_s(lambda: wp.match_all_arrays(
                    wtext, mesh=m8), 3)}
        del wtext, wsingle, out

        # Config 5 at 1 GiB: the literal route (spans, psum count) through
        # the API, and sharded_l_arrays on its DFA tables (fused).
        c5 = make_corpus(CONFIG5_SIZE, seed=4, needle=CONFIG1_PATTERN,
                         density=0.002)
        want5 = re_spans(CONFIG1_PATTERN, c5)
        check(len(want5) == c5.count(CONFIG1_PATTERN), "re and count")
        p5 = rt.Pattern(CONFIG1_PATTERN, device=DEV)
        check(p5.engine == "literal" and p5.info.overlap_free,
              "config 5 route")
        single5 = p5.match_all_arrays(c5)
        check(spans_of(single5) == want5, "config 5: single differs from re")
        for D, m in meshes.items():
            out = drive(f"config 5 D={D}",
                        lambda: p5.match_all_arrays(c5, mesh=m))
            check(same_arrays(out, single5), f"config 5 D={D} differs")
            cnt = drive(f"config 5 count D={D}",
                        lambda: p5.match_all_count(c5, mesh=m),
                        literal_count=D)
            check(cnt == len(want5), f"config 5 count D={D}: {cnt}")
        d5 = rt.Pattern(CONFIG1_PATTERN, rt.Config(engine="dfa"), device=DEV)
        arr5 = np.frombuffer(c5, np.uint8)
        with Recorder(targets) as rec:
            L5, I5 = drive("config 5 sharded_l_arrays D=8",
                           lambda: dsh.sharded_l_arrays(
                               d5.tables, arr5, m8, block=d5.fused_block,
                               engine="fused", cts=d5._mesh_tables(m8)),
                           schain_fused=MESH_D)
        pos = np.flatnonzero(L5 >= 0)
        check(pos.tolist() == [a for a, _ in want5]
              and L5[pos].tolist() == [b for _, b in want5]
              and not I5[pos].any() and len(L5) == len(c5) + 1,
              "config 5 sharded_l_arrays differs from re")
        held("config 5 fused, shard 4", rec.calls[4:5])
        del L5, I5, pos, rec
        emit({"phase": "mesh_config5", "n": len(c5),
              "matches": len(want5), "shards": list(meshes),
              "count_equal_to_bytes_count": True,
              "equal_to_single_device": True, "equal_to_re": True,
              "sharded_l_arrays_equal_to_re": True})
        if not quick:
            walls["config5_1GiB"] = {
                "single": wall_s(lambda: p5.match_all_arrays(c5), 3),
                **{f"D{D}": wall_s(lambda: p5.match_all_arrays(c5, mesh=m),
                                   3) for D, m in meshes.items()},
                "count_single": wall_s(lambda: p5.match_all_count(c5), 3),
                f"count_D{MESH_D}": wall_s(
                    lambda: p5.match_all_count(c5, mesh=m8), 3)}
        del c5, arr5, single5, out

        if walls:
            # "D8" against "single", "split_D8" against "split_single", ...
            over = {c: {k: v["median_s"]
                        / w[k.split("D")[0] + "single"]["median_s"]
                        for k, v in w.items() if "D" in k}
                    for c, w in walls.items()}
            emit({"phase": "mesh_walls", "walls": walls,
                  "overhead_vs_single": over})
        emit({"phase": "mesh_launches", "launches": total,
              "max_abs_err": errs, "skipped_tiles": skips})
    finally:
        for _, _, pr in workers:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    return total, errs


def route_phase(rt, main_text: bytes, reset, launches, only) -> dict:
    """Which kernels each DFA route setting launches, on config 3's
    pattern over the main text's first MiB (counts set to 0 just before
    each call, read just after): the default config and schain_fused='on'
    with matmul='on' take schain_fused alone; matmul='on' no kernel (the
    matmul engine's torch products); schain='on', pallas='on' and
    pallas='off' the split kernels alone (the fused route stands aside
    under 'auto', as in the JAX package); the stream under each setting
    the same kernels as its single-device call (the matmul engine falls
    to the split chunk engine there); mesh= the same launches with
    matmul='on' as without it. Every call's spans equal `re`."""
    from rejit_tpu_torch.dist.mesh import make_mesh

    text = main_text[:ROUTE_SIZE]
    want = re_spans(MAIN_PATTERN, text)
    cases = {"default": ({}, "fused"),
             "matmul_on": (dict(matmul="on"), "none"),
             "schain_on": (dict(schain="on"), "split"),
             "pallas_on": (dict(pallas="on"), "split"),
             "pallas_off": (dict(pallas="off"), "split"),
             "fused_on_with_matmul_on": (dict(schain_fused="on",
                                              matmul="on"), "fused")}
    kernels = {"fused": ("schain_fused",),
               "split": ("dfa_phase1", "dfa_phase3"), "none": ()}
    res = {}
    for label, (cfg, route) in cases.items():
        p = rt.Pattern(MAIN_PATTERN, rt.Config(**cfg), device=DEV)
        check(p.engine == "dfa", f"route {label}: engine {p.engine}")
        row = {"route": route}
        for call in ("match_all_arrays", "match_all_stream"):
            # The stream has no matmul engine: it takes the split kernels.
            r = "split" if (call == "match_all_stream"
                            and route == "none") else route
            reset()
            if call == "match_all_stream":
                out = p.match_all_stream(text, chunk_bytes=ROUTE_CHUNK)
            else:
                out = p.match_all_arrays(text)
            got = launches()
            check(spans_of(out) == want, f"route {label} {call}: spans")
            names = kernels[r]
            check(only(got, **{k: got[k] for k in names})
                  and all(got[k] > 0 for k in names),
                  f"route {label} {call}: launches {got}, want {r}")
            row[call] = got
        res[label] = row
    mesh = make_mesh([DEV] * MESH_D)
    for label, cfg in (("mesh", {}), ("mesh_matmul_on", dict(matmul="on"))):
        p = rt.Pattern(MAIN_PATTERN, rt.Config(**cfg), device=DEV)
        reset()
        out = p.match_all_arrays(text, mesh=mesh)
        got = launches()
        check(spans_of(out) == want, f"route {label}: spans")
        res[label] = {"match_all_arrays": got}
    check(res["mesh"] == res["mesh_matmul_on"]
          and sum(res["mesh"]["match_all_arrays"].values()) > 0,
          f"mesh= launches moved under matmul='on': {res['mesh']} "
          f"{res['mesh_matmul_on']}")
    emit({"phase": "routes", "n": len(text), "matches": len(want),
          "equal_to_re": True, **res})
    return res


def matmul_words():
    """The 40-word alternation of the matmul phase: 64 < Q <= 256 and
    C*Q*Q <= 2^20 (C*Q past the fused kernel's 4096, so 'auto' takes the
    split route for it)."""
    seed, count = MATMUL_WORDS
    return word_set(np.random.default_rng(seed), count)


def matmul_phase(rt, main_text: bytes, reset, launches, only) -> dict:
    """The matmul engine (Config(matmul='on'); engine/matmul.py, bf16
    torch products, no kernel of the port): L/I bit-equal to the split
    route (and to the fused kernel where it takes the tables) on config
    3's and the tokenizer's tables over the 10 MB main text and on the
    40-word alternation (Q = 179) over 1 MiB of letters with the words
    planted; no kernel launched; config 3's spans through the API equal
    to `re`."""
    from rejit_tpu_torch.engine import matmul as mm
    from rejit_tpu_torch.engine import pipeline
    from rejit_tpu_torch.kernels import schain_cuda as sc

    words = matmul_words()
    wtext = planted_words_text(words, MATMUL_WORDS_SIZE, 4096)
    res = {}
    for label, pats, text in (("config3", MAIN_PATTERN, main_text),
                              ("tokenizer", TOKENIZER, main_text),
                              ("40-word alternation", b"|".join(words),
                               wtext)):
        ct = dfa_tables(rt, pats)
        Q, C = ct.n_states, ct.n_classes
        check(Q <= mm.MAX_BLOCK and C * Q * Q <= 1 << 20,
              f"{label}: tables past the matmul engine")
        t = padded(text, DEV)
        n = len(text)
        reset()
        Lm, Im = mm.l_arrays_device_matmul(ct, t, n, block=K)
        got = launches()
        check(only(got), f"{label}: the matmul engine launched {got}")
        Ls, Is = pipeline.l_arrays_device(ct, t, n, block=K)
        check(torch.equal(Lm, Ls) and torch.equal(Im, Is),
              f"{label}: matmul L/I differ from the split route")
        row = {"n": n, "Q": Q, "C": C, "slab_blocks": mm.slab_blocks(Q),
               "slabs": -(-(t.shape[0] // K) // mm.slab_blocks(Q)),
               "candidates": int((Lm >= 0).sum()),
               "equal_to_split": True}
        if sc.fits(Q, C, ct.n_patterns):
            Lf, If = sc.l_arrays_device_staged(ct, t, n, block=K)
            If = If if If is not None else torch.where(Lf >= 0, 0, -1).to(
                torch.int32)
            check(torch.equal(Lm, Lf) and torch.equal(Im, If),
                  f"{label}: matmul L/I differ from the fused kernel")
            row["equal_to_fused"] = True
        res[label] = row
        del t, Lm, Im, Ls, Is
    p = rt.Pattern(MAIN_PATTERN, rt.Config(matmul="on"), device=DEV)
    check(not p.fused and p._use_matmul(), "matmul='on': route")
    reset()
    out = p.match_all_arrays(main_text)
    got = launches()
    check(only(got), f"matmul='on' match_all_arrays launched {got}")
    check(spans_of(out) == re_spans(MAIN_PATTERN, main_text),
          "matmul='on': spans differ from re")
    res["api"] = {"n": len(main_text), "matches": len(out[0]),
                  "launches": got, "equal_to_re": True}
    emit({"phase": "matmul", **res})
    return res


def matmul_times(rt, pats, text: bytes, label: str, reps: int) -> dict:
    """The matmul engine's L/I device time (CUDA events) and peak device
    memory on the tables of `pats`, beside the fused (where it takes the
    tables) and split routes on the same padded text, and
    match_all_arrays' wall under matmul='on' (host bytes, median)."""
    from rejit_tpu_torch.engine import matmul as mm
    from rejit_tpu_torch.engine import pipeline
    from rejit_tpu_torch.kernels import schain_cuda as sc

    ct = dfa_tables(rt, pats)
    t = padded(text, DEV)
    n = len(text)
    routes = {
        "matmul": lambda: mm.l_arrays_device_matmul(ct, t, n, block=K),
        "split": lambda: pipeline.l_arrays_device(ct, t, n, block=K),
    }
    if sc.fits(ct.n_states, ct.n_classes, ct.n_patterns):
        routes["fused"] = lambda: sc.l_arrays_device_staged(ct, t, n,
                                                            block=K)
    res = {"label": label, "n": n, "Q": ct.n_states, "C": ct.n_classes}
    for name, fn in routes.items():
        res[name + "_ms"] = time_ms(fn, reps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        res[name + "_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    p = rt.Pattern(pats, rt.Config(engine="dfa", matmul="on"), device=DEV)
    res["matmul_match_all_arrays_wall"] = wall_s(
        lambda: p.match_all_arrays(text), reps)
    return res


def matmul_profile(rt, text: bytes, reps: int) -> dict:
    """Where the matmul engine's device time goes on config 3's tables:
    torch.profiler over `reps` calls, device ms and launches a call by
    kernel (names cut at the first '<' or '('), the largest first. Run
    after every CUDA-event timing: the profiler slows later launches."""
    from torch.profiler import ProfilerActivity, profile

    from rejit_tpu_torch.engine import matmul as mm

    ct = dfa_tables(rt, MAIN_PATTERN)
    t = padded(text, DEV)
    n = len(text)
    mm.l_arrays_device_matmul(ct, t, n, block=K)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            mm.l_arrays_device_matmul(ct, t, n, block=K)
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        if us <= 0:
            continue
        name = re.split(r"[<(]", e.key.replace("void ", ""), 1)[0].strip()
        ms, calls = rows.get(name, (0.0, 0.0))
        rows[name] = (ms + us / reps / 1e3, calls + e.count / reps)
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])
    return {"n": n, "device_ms": sum(v[0] for v in rows.values()),
            "launches": sum(v[1] for v in rows.values()),
            "by_kernel": [{"name": k, "ms": v[0], "launches": v[1]}
                          for k, v in top[:10]]}


def quiet_call(fn, *args) -> tuple:
    """(fn(*args), its stdout, its stderr), both captured."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        got = fn(*args)
    return got, out.getvalue(), err.getvalue()


def verify_phase(subset: int) -> dict:
    """The on-card gate (rejit_tpu_torch/tools/verify_cuda.py) in this
    process: every `subset`-th conformance case (1: all 140) under each
    setting, and the DFA routes' L/I bit-equality at 1 MiB."""
    from rejit_tpu_torch.tools import verify_cuda

    t0 = time.perf_counter()
    rc, out, err = quiet_call(verify_cuda.main,
                              ["--subset", str(subset), "--size", "1"])
    wall = time.perf_counter() - t0
    if rc != 0:
        print(err[-20000:], file=sys.stderr)
    check(rc == 0, f"verify_cuda exited {rc}: {out.strip()[-2000:]}")
    summary = json.loads(out.strip().splitlines()[-1])
    emit({"phase": "verify_cuda", "subset": subset, "wall_s": wall,
          "summary": summary})
    return summary


def jrep_tree(root: str, text: bytes) -> list:
    """The jrep phase's tree under `root`: JREP_FILES files of
    JREP_FILE_BYTES of `text` (config 3's words, a newline every
    JREP_LINE_WORDS words), and small files of ^ / $ lines. Returns the
    files in the order jrep -r walks them."""
    arr = np.frombuffer(text[:JREP_FILES * JREP_FILE_BYTES],
                        np.uint8).copy()
    spaces = np.flatnonzero(arr == ord(" "))
    arr[spaces[JREP_LINE_WORDS - 1::JREP_LINE_WORDS]] = ord("\n")
    big = os.path.join(root, "big")
    small = os.path.join(root, "small")
    os.makedirs(big)
    os.makedirs(small)
    for i in range(JREP_FILES):
        part = arr[i * JREP_FILE_BYTES:(i + 1) * JREP_FILE_BYTES]
        with open(os.path.join(big, f"f{i:02d}.txt"), "wb") as f:
            f.write(part.tobytes())
    for name, body in (("a.txt", b"singing\nnot singing here\nringing\n"),
                       ("b.txt", b"\nking\n\nwing\nthing"),
                       ("c.txt", b"nothing to see\n"),
                       ("empty.txt", b"")):
        with open(os.path.join(small, name), "wb") as f:
            f.write(body)
    files = []
    for d, _, names in os.walk(root):
        files += [os.path.join(d, x) for x in sorted(names)]
    return files


def grep_expected(files, pattern: bytes, flags: int, mode: str) -> str:
    """What jrep prints for several files (names prefixed) by Python `re`:
    mode 'lines' (-n), 'count_lines' (-c) or 'count_matches'."""
    out = []
    for path in files:
        with open(path, "rb") as f:
            data = f.read()
        starts = np.array([m.start() for m in re.finditer(pattern, data,
                                                            flags)],
                          dtype=np.int64)
        if mode == "count_matches":
            out.append(f"{path}:{len(starts)}")
            continue
        nl = np.flatnonzero(np.frombuffer(data, np.uint8) == 0x0A)
        lines = np.unique(np.searchsorted(nl, starts, side="left"))
        if mode == "count_lines":
            out.append(f"{path}:{len(lines)}")
            continue
        for ln in lines.tolist():
            lo = int(nl[ln - 1]) + 1 if ln > 0 else 0
            hi = int(nl[ln]) if ln < len(nl) else len(data)
            out.append(f"{path}:{ln + 1}:"
                       + data[lo:hi].decode("utf-8", "replace"))
    return "".join(x + "\n" for x in out)


def jrep_phase(root: str, main_text: bytes, reset, launches) -> dict:
    """The port's jrep (rejit_tpu_torch/tools/jrep.py) on the card, in this
    process, over a generated tree (jrep_tree): batched (one call for
    many files: classlit, on scan1d, and a literal), per file (the DFA
    engine's tables may step on a newline; `ing\\s+\\w+` consumes one),
    -c, --count-matches, --stream and ^ / $ lines; each run's output
    equal to the lines Python `re` selects, its launches and its wall. Then `def \\w+ing` over
    the port's sources on the card and on the CPU, equal."""
    import shutil
    import tempfile

    from rejit_tpu_torch.tools import jrep

    tmp = tempfile.mkdtemp(prefix="jrep_tree_")
    try:
        big_text = main_text * (-(-JREP_FILES * JREP_FILE_BYTES
                                  // len(main_text)))
        files = jrep_tree(tmp, big_text)
        del big_text
        word = rb"\b\w+ing\b"   # the DFA may step on '\n': per file
        runs = {
            # classlit (scan1d) and literal patterns cannot consume '\n':
            # many files a call
            "batched": (["-r", "-n"], B3_PATTERNS["classlit"][0], 0,
                        "lines"),
            "batched_count_lines": (["-r", "-c"], CONFIG1_PATTERN, 0,
                                    "count_lines"),
            "per_file": (["-r", "-n"], word, 0, "lines"),
            "per_file_newlines": (["-r", "-n"], rb"ing\s+\w+", 0,
                                  "lines"),
            "count_lines": (["-r", "-c"], word, 0, "count_lines"),
            "count_matches": (["-r", "--count-matches"], word, 0,
                              "count_matches"),
            "stream": (["-r", "-n", "--stream", "0.25"], word, 0, "lines"),
            "anchors": (["-r", "-n"], rb"^\w+ing$", re.M, "lines"),
        }
        res = {"files": len(files), "bytes": sum(os.path.getsize(f)
                                                 for f in files)}
        for name, (flags, pat, reflags, mode) in runs.items():
            argv = flags + [pat.decode(), tmp]
            reset()
            t0 = time.perf_counter()
            rc, out, err = quiet_call(jrep.main, argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = launches()
            want = grep_expected(files, pat, reflags, mode)
            check(out == want, f"jrep {name}: output differs from re "
                  f"({len(out)} vs {len(want)} chars) {err[-500:]}")
            check(rc == (0 if any(not x.endswith(":0")
                                  for x in want.splitlines()) else 1),
                  f"jrep {name}: exit code {rc}")
            if name == "batched":
                check(0 < got["scan1d"] < len(files),
                      f"jrep batched: {got['scan1d']} scan1d launches for "
                      f"{len(files)} files")
            res[name] = {"argv": flags + [pat.decode()], "wall_s": wall,
                         "output_lines": want.count("\n"),
                         "launches": got, "equal_to_re": True}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    pkg = os.path.dirname(os.path.abspath(jrep.__file__))
    pkg = os.path.dirname(pkg)
    srcs = sorted(os.path.join(d, x) for d, _, names in os.walk(pkg)
                  for x in names if x.endswith(".py"))
    outs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        rc, out, _ = quiet_call(jrep.main, ["-n", r"def \w+ing", *srcs,
                                            "--device", dev])
        outs[dev] = (rc, out, time.perf_counter() - t0)
    check(outs["cuda"][:2] == outs["cpu"][:2] and outs["cuda"][0] == 0,
          "jrep over the port's sources: card and CPU differ")
    res["port_sources"] = {"files": len(srcs),
                           "lines": outs["cuda"][1].count("\n"),
                           "wall_s": outs["cuda"][2],
                           "cpu_wall_s": outs["cpu"][2],
                           "equal_to_cpu": True}
    emit({"phase": "jrep", **res})
    return res


def profile_phase(root: str) -> dict:
    """profile_match (rejit_tpu_torch/tools/profile_match.py) at 10 MiB on
    the card, as a process of its own (the profiler slows later launches
    in its process): the Chrome trace exists, parses, and names the
    schain_fused kernels."""
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="profile_match_")
    path = os.path.join(out_dir, "trace.json")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "rejit_tpu_torch.tools.profile_match",
         MAIN_PATTERN.decode(), "--size", str(PROFILE_SIZE_MB), "--out",
         path], cwd=root, env=dict(os.environ, PYTHONPATH=root),
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"profile_match exited {r.returncode}: "
          f"{r.stderr[-3000:]}")
    with open(path) as f:
        trace = json.load(f)
    os.remove(path)
    os.rmdir(out_dir)
    kern = [e for e in trace.get("traceEvents", [])
            if e.get("cat") == "kernel"]
    names = sorted({e["name"] for e in kern})
    fused = [x for x in names
             if re.search(r"\b(sweep|schain)_\w*kernel\b", x)]
    check(fused, f"profile_match trace names no schain_fused kernel: "
          f"{names[:20]}")
    res = {"size_mib": PROFILE_SIZE_MB, "wall_s": wall,
           "events": len(trace["traceEvents"]), "kernel_events": len(kern),
           "fused_kernels": fused, "kernel_names": len(names),
           "kernel_us": sum(e.get("dur", 0) for e in kern),
           "stdout": r.stdout.strip().splitlines()[-1]}
    emit({"phase": "profile_match", **res})
    return res


def samples_phase(dna_checked: dict) -> dict:
    """The samples on the card, in this process: basic prints what its
    CPU run prints; regexdna at DNA_BASES prints the counts and lengths
    that replace_phase held against Python `re`."""
    from rejit_tpu_torch.samples import basic, regexdna

    res = {}
    outs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        rc, out, _ = quiet_call(basic.main, ["--device", dev])
        outs[dev] = out
        check(rc == 0, f"basic on {dev} exited {rc}")
        res[f"basic_{dev}_wall_s"] = time.perf_counter() - t0
    check(outs["cuda"] == outs["cpu"], "basic: card and CPU print differ")
    t0 = time.perf_counter()
    rc, out, err = quiet_call(regexdna.main, [str(DNA_BASES)])
    res["regexdna_wall_s"] = time.perf_counter() - t0
    check(rc == 0, f"regexdna exited {rc}")
    lines = out.splitlines()
    want = ([f"{v} {c}" for v, c in dna_checked["counts"].items()] + [""]
            + [str(x) for x in dna_checked["lengths"]])
    check(lines == want, f"regexdna prints {lines}, want {want}")
    res.update(basic_lines=len(outs["cuda"].splitlines()),
               basic_equal_to_cpu=True, regexdna_bases=DNA_BASES,
               regexdna_equal_to_re=True,
               regexdna_own_timing=err.strip())
    emit({"phase": "samples", **res})
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    quick = "--quick" in args
    root = os.path.dirname(os.path.abspath(__file__))
    if "--port-root" in args:
        root = os.path.abspath(args[args.index("--port-root") + 1])
    sys.path.insert(0, root)
    import rejit_tpu_torch as rt
    check(os.path.abspath(rt.__file__).startswith(root + os.sep),
          f"rejit_tpu_torch imported from {rt.__file__}, not {root}")
    from rejit_tpu_torch.kernels import build
    from rejit_tpu_torch.kernels import dfa_cuda as dc
    from rejit_tpu_torch.kernels import extract_cuda as xc
    from rejit_tpu_torch.kernels import literal as lk
    from rejit_tpu_torch.kernels import probe_cuda as pc
    from rejit_tpu_torch.kernels import scan_cuda as scn
    from rejit_tpu_torch.kernels import schain_cuda as sc
    from rejit_tpu_torch.utils.corpus import make_corpus

    counters = (dc, sc, xc, scn, pc, lk)

    def launches():
        torch.cuda.synchronize()
        return {k: v for m in counters for k, v in m.LAUNCHES.items()}

    def reset():
        torch.cuda.synchronize()
        for m in counters:
            m.reset_launches()

    def only(got: dict, **want) -> bool:
        """Every counter is 0 but those named, which have these counts."""
        return all(v == want.get(k, 0) for k, v in got.items())

    # 1. The card and the build.
    card = nvidia_smi("name,power.limit")
    props = torch.cuda.get_device_properties(0)
    t0 = time.perf_counter()
    built = build.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "sms": props.multi_processor_count, "build_s": build_s,
          "ptxas": {k: v["ptxas"] for k, v in built.items()},
          "port": rt.__file__})
    if "--times" in args:
        {"b1": b1_times, "scan": scan_times, "tile": tile_times,
         "count": count_times}[
            args[args.index("--times") + 1]](rt, reps=20)
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    # 2. Kernels against their plain versions, bit for bit.
    main_text = make_corpus(10_000_000, seed=2, needle=b"matching",
                            density=0.01)
    sp_text = sparse_text(10_000_000, seed=5)
    errs = {"dfa_phase1": 0, "dfa_phase3": 0, "schain_fused": 0,
            "schain_fused_emit_f": 0}
    rng = np.random.default_rng(7)
    alphabet = np.frombuffer(b"abfo liner\n singing! foo bar baz line", np.uint8)
    words = word_set(rng, 250)
    cases = [(str(pats), pats, alphabet, True)
             for pats in (rb"\b\w+ing\b", rb"[a-z]+", rb"foo|bar|baz", rb"a*",
                          rb"^line", TOKENIZER)]
    # 250 random words: Q = 871, C = 27, a 94 KB table, which the split
    # kernels keep in shared memory; too large for the fused kernel. 1000
    # words: a table past the shared-memory limit, read through the
    # read-only cache.
    cases.append(("250-word alternation", b"|".join(words), WORD_CHARS, True))
    cases.append(("1000-word alternation",
                  b"|".join(word_set(np.random.default_rng(11), 1000)),
                  WORD_CHARS, False))
    for j, (label, pats, chars, in_smem) in enumerate(cases):
        size = 200_000 + 37 + j  # n is not a multiple of K
        text = rng.choice(chars, size=size).tobytes()
        e = split_kernels_vs_plain(rt, pats, text, DEV, seed=j)
        ct = dfa_tables(rt, pats)
        emit({"phase": "kernel_vs_plain", "patterns": label, "n": size,
              "Q": ct.n_states, "C": ct.n_classes,
              "table_bytes": ct.packed.numel() * 4, "max_abs_err": e})
        check(e.pop("smem_table") == in_smem,
              f"{label}: unexpected table placement")
        check(e.pop("dead_stop_change") == 0,
              f"{label}: stopping at the dead state changed the outputs")
        errs["dfa_phase3"] = max(errs["dfa_phase3"],
                                 e.pop("dfa_phase3_first_start"))
        for k in e:
            errs[k] = max(errs[k], e[k])
    # The split route's shapes at 10 MB: the main text, and the 250-word
    # alternation on letters (its table in shared memory).
    words10 = words_text(len(main_text))
    for label, pats, text in (("main path shapes", MAIN_PATTERN, main_text),
                              ("250-word alternation", b"|".join(words),
                               words10)):
        e = split_kernels_vs_plain(rt, pats, text, DEV, seed=99, full=False)
        emit({"phase": "kernel_vs_plain", "patterns": label,
              "n": len(text), "max_abs_err": e})
        e.pop("smem_table")
        e.pop("dead_stop_change")
        e["dfa_phase3"] = max(e["dfa_phase3"], e.pop("dfa_phase3_first_start"))
        for k in e:
            errs[k] = max(errs[k], e[k])

    # schain_fused: 6 sets of the split phase (Q = 2..7), a 14- and a
    # 30-state set (sweep widths 16 and 32) and two large-Q sets (82 and
    # 242 states: 16 and 8 sub-blocks a tile), dense and sparse texts.
    long_words = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz" * 4 + b" ",
                               np.uint8)
    fcases = [c[:3] for c in cases[:-2]] + [
        (r"\b(the|and|for|with|from)\b", rb"\b(the|and|for|with|from)\b",
         np.frombuffer(b"theandforwithfrom  ", np.uint8)),
        (r"\b[a-z]{20,28}\b", rb"\b[a-z]{20,28}\b",
         np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)),
        (r"\b[a-z]{40,80}\b", rb"\b[a-z]{40,80}\b", long_words),
        (r"\b[a-z]{100,240}\b", rb"\b[a-z]{100,240}\b", long_words),
    ]
    sparse_small = sparse_text(200_000, seed=11)
    emit_f_skips = {"sweep": 0, "tile": 0}

    def emit_f_check(ct, t, ns, what: dict, **kw):
        """schain_fused with emit_f (L and L+I modes) against its plain
        version, from the begin context and another start state at byte
        0."""
        fs = (int(ct.plan.start_by_ctx[0]) + 1) % ct.n_states
        e = fused_vs_plain(ct, t, ns, modes=("l", "li"), emit_f=True,
                           first_starts=(None, fs), **kw)
        emit({"phase": "fused_emit_f_vs_plain", **what, "Q": ct.n_states,
              "first_start": fs, **e})
        errs["schain_fused_emit_f"] = max(errs["schain_fused_emit_f"],
                                          e["max_abs_err"], e["f_past_n_err"])
        for inst, v in e["skipped_tiles"].items():
            emit_f_skips[inst] += v

    skipped_total = {"sweep": 0, "tile": 0}
    fused_calls = {"sweep": 0, "tile": 0}
    for j, (label, pats, chars) in enumerate(fcases):
        ct = dfa_tables(rt, pats)
        for kind in ("dense", "sparse"):
            text = (rng.choice(chars, size=200_000).tobytes()
                    if kind == "dense" else sparse_small)
            t = padded(text, DEV)
            P = t.shape[0]
            e = fused_vs_plain(ct, t, (P, P - 3, 3 * sc.TILE, 1, 0))
            emit({"phase": "fused_vs_plain", "patterns": label, "text": kind,
                  "P": P, "Q": ct.n_states, "skip_plan": ct.plan.skip, **e})
            errs["schain_fused"] = max(errs["schain_fused"], e["max_abs_err"])
            emit_f_check(ct, t, (P, P - 3, 3 * sc.TILE, 1, 0),
                         dict(patterns=label, text=kind, P=P))
            for inst in e["instances"]:
                skipped_total[inst] += e["skipped_tiles"][inst]
                fused_calls[inst] += 1
    # Other fused blocks K (Config.fused_block), a power of two or not.
    for pats in (MAIN_PATTERN, TOKENIZER):
        ct = dfa_tables(rt, pats)
        for kb in (8, 24, 64):
            t = padded(sparse_small[:150_000] + main_text[:50_000], DEV, kb)
            P = t.shape[0]
            e = fused_vs_plain(ct, t, (P, P - 3, 1), block=kb)
            emit({"phase": "fused_vs_plain", "patterns": str(pats),
                  "text": "mixed", "block": kb, "P": P, **e})
            errs["schain_fused"] = max(errs["schain_fused"], e["max_abs_err"])
            emit_f_check(ct, t, (P, P - 3, 1),
                         dict(patterns=str(pats), text="mixed", P=P),
                         block=kb)
    # The 10 MB texts, where a sweep chunk is several tiles: the main
    # pattern (W = 8) and a 17-state suffix set (W = 32), at the sweep
    # instance's tile, chunk and segment edges of each mode.
    for pats in (MAIN_PATTERN, rb"\b\w+(ing|tion|ment|ness)\b"):
        ct = dfa_tables(rt, pats)
        for kind, text in (("main", main_text), ("sparse", sp_text)):
            t = padded(text, DEV)
            P = t.shape[0]
            e = fused_vs_plain(ct, t, (P, P - 3), edges=True)
            emit({"phase": "fused_vs_plain", "patterns": str(pats),
                  "text": kind, "P": P, "Q": ct.n_states, **e})
            errs["schain_fused"] = max(errs["schain_fused"], e["max_abs_err"])
            emit_f_check(ct, t, (P, P - 3),
                         dict(patterns=str(pats), text=kind, P=P),
                         edges=True)
            if kind == "sparse" and pats == MAIN_PATTERN:
                sparse_skips = e
    emit({"phase": "fused_instances", "cases": fused_calls,
          "skipped_tiles": skipped_total})
    # literal_spans: 4 literal sets x 4 caps x 6 n; and at the keyword
    # path's shapes on the main text.
    sets = literal_sets(rng)
    e = literal_spans_vs_plain(xc, literal_text(rng, sets, 300_000), sets)
    emit({"phase": "literal_spans_vs_plain", "sets": [
        {"literals": len(l), "lengths": sorted({len(x) for x in l}),
         "pids": sorted(set(q))} for l, q in sets], **e})
    check(e["max_row_count"] > 16, "no row count past cap 16")
    errs["literal_spans"] = e["max_abs_err"]
    kw_lits = rt.Pattern(b"|".join(KEYWORDS), device=DEV).info.literals
    e = literal_spans_vs_plain(
        xc, np.frombuffer(main_text, np.uint8),
        [(kw_lits, tuple(range(12))), (kw_lits, (0,) * 12)])
    emit({"phase": "literal_spans_vs_plain", "sets": "keywords on the main "
          "text", **e})
    errs["literal_spans"] = max(errs["literal_spans"], e["max_abs_err"])
    # scan1d: both directions at lengths around its tile, 256 Mi and the
    # main path's length, offset views, repeated calls.
    e = scan_vs_plain(scn, (1, 31, 4095, 4096, 4097, 1_000_003,
                            len(main_text), 1 << 28), seed=7)
    emit({"phase": "scan1d_vs_plain", **e})
    errs["scan1d"] = e["max_abs_err"]
    check(all(v == 0 for v in errs.values()),
          f"kernels differ from their plain versions: {errs}")
    check(all(v > 0 for v in fused_calls.values()),
          f"a schain_fused instance was never held: {fused_calls}")
    check(all(v > 0 for v in skipped_total.values())
          and all(v > 0 for v in sparse_skips["skipped_tiles"].values())
          and all(v > 0 for v in emit_f_skips.values()),
          "the FF tile skip was never taken")

    # 3. The main path at the published config-3 size: the fused route.
    p = rt.Pattern(MAIN_PATTERN, device=DEV)
    check(p.fused and sc.instance_for(p.ct.n_states) == "sweep",
          "main pattern not on the fused route's sweep instance")
    reset()
    t0 = time.perf_counter()
    out = p.match_all_arrays(main_text)
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    main_launches = launches()
    check(main_launches["schain_fused"] > 0
          and main_launches["dfa_phase1"] == 0
          and main_launches["dfa_phase3"] == 0,
          f"main path launches: {main_launches}")
    got = spans_of(out)
    want = re_spans(MAIN_PATTERN, main_text)
    check(got == want, f"spans differ from re: {len(got)} vs {len(want)}")
    check(len(got) == 16897, f"expected 16897 matches, got {len(got)}")
    cpu = rt.Pattern(MAIN_PATTERN, device="cpu")
    check(not cpu.fused, "CPU auto route")
    cpu_out = cpu.match_all_arrays(main_text)
    check(all(np.array_equal(a, b) for a, b in zip(out, cpu_out)),
          "card and CPU runs differ")
    count = p.match_all_count(main_text)
    check(count == len(got), f"match_all_count {count} != {len(got)}")
    # Count mode: the kernel's candidate count (every candidate of this
    # pattern on this text is a match) and the API's count route for an
    # overlap-free pattern.
    reset()
    t = padded(main_text, DEV)
    kcount = int(sc.count_device_staged(p.ct, t, len(main_text), block=K))
    check(kcount == len(got), f"count mode {kcount} != {len(got)}")
    # `matching` alone takes the literal engine; the DFA engine is forced
    # here to hold the fused count route.
    cp = rt.Pattern(COUNT_PATTERN, rt.Config(engine="dfa"), device=DEV)
    check(cp.info.overlap_free and cp.fused, "count pattern route")
    reset()
    ccount = cp.match_all_count(main_text)
    count_launches = launches()
    check(only(count_launches, schain_fused=1), f"count: {count_launches}")
    check(ccount == len(re_spans(COUNT_PATTERN, main_text))
          == len(cp.match_all(main_text)), f"count pattern: {ccount}")
    # A staged corpus on every entry point, shared by two patterns.
    corpus = rt.stage(main_text, DEV)
    for pat in (p, cp):
        for op in ENTRY_POINTS:
            check(getattr(pat, op)(corpus) == getattr(pat, op)(main_text),
                  f"staged {op} differs")
    check(corpus.uploads == 1, f"corpus uploads {corpus.uploads}")
    emit({"phase": "main_path", "pattern": MAIN_PATTERN.decode(),
          "n": len(main_text), "matches": len(got), "first_call_wall_s":
          first_wall, "launches": main_launches, "equal_to_re": True,
          "equal_to_cpu": True, "match_all_count": count,
          "count_mode_candidates": kcount,
          "count_pattern": COUNT_PATTERN.decode(),
          "count_pattern_count": ccount, "count_launches": count_launches,
          "staged_entry_points_equal": True,
          "staged_uploads": corpus.uploads})
    del corpus

    # 3b. Log search: the tile instance's workloads (Q = 37..40).
    log = log_phase(rt, reset, launches, only, quick)
    errs["schain_fused"] = max(errs["schain_fused"], log["max_abs_err"])
    check(log["max_abs_err"] == 0, "schain_fused differs from its plain "
          "version on the log-search workloads")

    # 4. The split kernels on their paths, and the tokenizer.
    wtext = rng.choice(WORD_CHARS, size=1 << 20).tobytes()
    wp = rt.Pattern(b"|".join(words), device=DEV)
    check(not wp.fused, "250-word alternation took the fused route")
    reset()
    wout = wp.match_all_arrays(wtext)
    words_launches = launches()
    longest_first = b"|".join(sorted(words, key=len, reverse=True))
    check(spans_of(wout) == re_spans(longest_first, wtext),
          "250-word alternation: spans differ from re")
    off = rt.Pattern(MAIN_PATTERN, rt.Config(schain_fused="off"),
                     device=DEV)
    reset()
    off_out = off.match_all_arrays(main_text)
    off_launches = launches()
    check(spans_of(off_out) == want, "split route: spans differ from re")
    split_launches = {k: words_launches[k] + off_launches[k]
                      for k in ("dfa_phase1", "dfa_phase3")}
    check(all(got["dfa_phase1"] > 0 and got["dfa_phase3"] > 0
              and got["schain_fused"] == 0
              for got in (words_launches, off_launches)),
          f"split paths: {words_launches} {off_launches}")
    emit({"phase": "split_paths", "words_n": len(wtext),
          "words_matches": len(wout[0]), "words_launches": words_launches,
          "off_launches": off_launches, "equal_to_re": True})

    tok_text = main_text[:1 << 20]
    reset()
    tok = rt.Pattern(TOKENIZER, device=DEV).tokenize(tok_text)
    tok_launches = launches()
    tok_cpu = rt.Pattern(TOKENIZER, device="cpu").tokenize(tok_text)
    check(tok == tok_cpu, "tokenizer: card and CPU runs differ")
    check(tok_launches["schain_fused"] > 0, f"tokenizer: {tok_launches}")
    from rejit_tpu_torch.engine import pipeline
    _, cand, n_cand = pipeline.ff_phase12(off.ct, padded(sp_text, DEV),
                                          len(sp_text), K)
    cand_frac = int(n_cand) / cand.shape[0]
    check(cand_frac < 0.75, f"sparse text is not sparse: {cand_frac}")
    reset()
    ff_out = off.match_all_arrays(sp_text)
    ff_launches = launches()
    check(ff_launches["dfa_phase1"] > 0 and ff_launches["dfa_phase3"] > 0,
          f"FF route: {ff_launches}")
    ff_fused = p.match_all_arrays(sp_text)
    check(all(np.array_equal(a, b) for a, b in zip(ff_out, ff_fused)),
          "FF route and fused route differ")
    check(spans_of(ff_out) == re_spans(MAIN_PATTERN, sp_text),
          "FF route: spans differ from re")
    emit({"phase": "tokenizer", "n": len(tok_text), "tokens": len(tok),
          "launches": tok_launches, "equal_to_cpu": True})
    emit({"phase": "ff_route", "n": len(sp_text), "candidate_blocks":
          cand_frac, "matches": len(ff_out[0]), "launches": ff_launches,
          "fused_tiles": sparse_skips["tiles"],
          "fused_skipped_tiles": sparse_skips["skipped_tiles"],
          "equal_to_fused": True, "equal_to_re": True})

    # 5. Config 1, the bench.py program: one literal on the literal
    # engine's bitmask route (torch ops, no kernel of its own).
    c1_text = make_corpus(CONFIG1_SIZE, seed=0, needle=b"packet",
                          density=0.002)
    c1 = rt.Pattern(CONFIG1_PATTERN, device=DEV)
    check(c1.engine == "literal" and c1._bitmask_ok() and c1.ct is None,
          "config 1 route")
    reset()
    c1_out = c1.match_all_arrays(c1_text)
    c1_launches = launches()
    check(only(c1_launches), f"config 1 launched kernels: {c1_launches}")
    c1_want = re_spans(CONFIG1_PATTERN, c1_text)
    check(spans_of(c1_out) == c1_want, "config 1: spans differ from re")
    check(c1.last_stats.engine == "literal", "config 1 stats")
    check(c1.match_all_count(c1_text) == len(c1_want), "config 1 count")
    check(c1.match_first(c1_text) == c1_want[0], "config 1 match_first")
    check(c1.match_anywhere(c1_text) and not c1.match_full(c1_text),
          "config 1 match_anywhere / match_full")
    corpus = rt.stage(c1_text, DEV)
    for op in ENTRY_POINTS:
        check(getattr(c1, op)(corpus) == getattr(c1, op)(c1_text),
              f"config 1: staged {op} differs")
    check(corpus.uploads == 1, f"config 1 corpus uploads {corpus.uploads}")
    emit({"phase": "config1_path", "pattern": CONFIG1_PATTERN.decode(),
          "n": len(c1_text), "matches": len(c1_want),
          "launches": c1_launches, "equal_to_re": True,
          "staged_entry_points_equal": True})
    del corpus

    # 6. The literal_spans path: 12 overlap-free keywords (past the bitmask
    # route's 8) on the config-3 text, as an alternation and as a list.
    kw = b"|".join(KEYWORDS)
    kp = rt.Pattern(kw, device=DEV)
    check(kp.engine == "literal" and kp.info.overlap_free
          and not kp._bitmask_ok() and kp._spans_kernel_ok(None),
          "keyword route")
    reset()
    kw_out = kp.match_all_arrays(main_text)
    kw_launches = launches()
    # The first call (cap 4) counts a row past the cap, so the call runs
    # again with a larger cap.
    check(only(kw_launches, literal_spans=kw_launches["literal_spans"])
          and kw_launches["literal_spans"] >= 2, f"keywords: {kw_launches}")
    kw_want = re_spans(kw, main_text)
    check(spans_of(kw_out) == kw_want, "keywords: spans differ from re")
    check(kp.match_all_count(main_text) == len(kw_want), "keywords count")
    tp = rt.Pattern(list(KEYWORDS), device=DEV)
    reset()
    kw_tok = tp.tokenize(main_text)
    tok_kw_launches = launches()
    check(tok_kw_launches["literal_spans"] >= 1
          and only(tok_kw_launches,
                   literal_spans=tok_kw_launches["literal_spans"]),
          f"keyword list: {tok_kw_launches}")
    check(kw_tok == rt.Pattern(list(KEYWORDS), device="cpu").tokenize(
        main_text), "keyword list: card and CPU tokenize differ")
    check(sorted({t[2] for t in kw_tok}) == list(range(12)),
          "keyword list: not every pid matched")
    emit({"phase": "literal_spans_path", "n": len(main_text),
          "matches": len(kw_want), "launches": kw_launches,
          "list_launches": tok_kw_launches, "equal_to_re": True,
          "list_equal_to_cpu": True})
    # The literal_count kernel: against its plain version, its path (the
    # literal cell's count), and its times at 10 MB, 256 MiB and 2e9 bytes.
    lc_launches, errs["literal_count"], lc_times = literal_count_phase(
        rt, reset, launches, only, quick)
    check(errs["literal_count"] == 0, "literal_count differs from its "
          "plain version")

    # 7. The scan1d paths: classrun and classlit on the config-3 text.
    b3 = {}
    for name, (pat, per_call) in B3_PATTERNS.items():
        bp = rt.Pattern(pat, device=DEV)
        check(bp.engine == name, f"{pat!r} took {bp.engine}")
        reset()
        b_out = bp.match_all_arrays(main_text)
        b_launches = launches()
        check(only(b_launches, scan1d=per_call), f"{name}: {b_launches}")
        d_out = rt.Pattern(pat, rt.Config(engine="dfa"),
                           device=DEV).match_all_arrays(main_text)
        check(all(np.array_equal(a, b) for a, b in zip(b_out, d_out)),
              f"{name}: spans differ from the DFA route")
        b_want = re_spans(pat, main_text)
        check(spans_of(b_out) == b_want, f"{name}: spans differ from re")
        check(bp.match_all_count(main_text) == len(b_want),
              f"{name}: match_all_count")
        b3[name] = b_launches["scan1d"]
        emit({"phase": name + "_path", "pattern": pat.decode(),
              "n": len(main_text), "matches": len(b_want),
              "launches": b_launches, "equal_to_dfa_route": True,
              "equal_to_re": True})
    # The plain torch routes on the card (Config(pallas='off')) agree too.
    off_b3 = rt.Pattern(B3_PATTERNS["classlit"][0], rt.Config(pallas="off"),
                        device=DEV)
    reset()
    check(spans_of(off_b3.match_all_arrays(main_text)) == re_spans(
        B3_PATTERNS["classlit"][0], main_text), "pallas='off' classlit")
    check(only(launches()), "pallas='off' launched a kernel")

    # 8. The stream path: 256 MiB in 8 MiB chunks on both routes, killed
    # and resumed, and the early exit.
    del words10
    emit_f_row = stream_phase(rt, p, wp, words, quick, reset, launches,
                              only)
    errs["schain_fused_emit_f"] = max(errs["schain_fused_emit_f"],
                                      emit_f_row.pop("max_abs_err"))
    check(errs["schain_fused_emit_f"] == 0, "schain_fused emit_f differs "
          "from its plain version at the stream path's shapes")

    # 9. The gather probe, the last TPU kernel: held against its plain
    # version, then its own path (both modes, one block and the card).
    probe_row = gather_probe_phase(reset, launches, quick)
    errs["gather_probe"] = probe_row.pop("max_abs_err")

    # 10. The DFA-blowup fallback chain: the posnfa engine on the JAX
    # package's posnfa workload (10 MB), and the oracle route.
    posnfa = posnfa_phase(rt, reset, launches, only, quick)

    # 11. regex-dna at its published size through the Replace path, and
    # device-side selection against the host walk.
    dna_launches, dna_errs, dna_checked = replace_phase(
        rt, main_text, reset, launches, only, quick)
    for k, v in dna_errs.items():
        errs[k] = max(errs[k], v)
    check(all(v == 0 for v in dna_errs.values()),
          f"kernels differ from their plain versions at the regex-dna "
          f"path's shapes: {dna_errs}")
    sel_launches = select_phase(rt, reset, launches, only, quick)

    # 12. The mesh= path: D shards on the card against the single device.
    mesh_launches, mesh_errs = mesh_phase(rt, root, main_text, words, reset,
                                          launches, only, quick)
    for k, v in mesh_errs.items():
        errs[k] = max(errs[k], v)
    check(all(v == 0 for v in mesh_errs.values()),
          f"kernels differ from their plain versions at the mesh path's "
          f"shapes: {mesh_errs}")

    # 13. The DFA routes' launch counts under each route setting.
    route_phase(rt, main_text, reset, launches, only)

    # 14. The matmul engine: bit-equal to the split route, no kernel.
    matmul_phase(rt, main_text, reset, launches, only)

    # 15. The on-card gate: the conformance corpus, every case.
    verify_phase(subset=1)

    # 16. The tools and samples on the card.
    jrep_phase(root, main_text, reset, launches)
    profile_phase(root)
    samples_phase(dna_checked)

    # 17. Times at 10 MB and 256 MiB.
    times = {}
    if not quick:
        t10, _ = time_size(rt, main_text, "10MB", reps=20, wall_reps=10)
        emit({"phase": "times", **t10})
        emit({"phase": "times_matmul", "set": "config 3",
              **matmul_times(rt, MAIN_PATTERN, main_text, "10MB",
                             reps=10)})
        words40 = matmul_words()
        emit({"phase": "times_matmul", "set": "40-word alternation",
              **matmul_times(rt, b"|".join(words40), planted_words_text(
                  words40, MATMUL_WORDS_SIZE, 4096), "1MiB", reps=5)})
        tl10 = time_literal_engines(rt, main_text, "10MB", reps=20,
                                    walls=True)
        emit({"phase": "times_literal_engines", **tl10})
        emit({"phase": "scan_paths_device_s",
              **scan_paths_device_s(rt, main_text, "10MB", 5)})
        tc10 = time_config1(rt, c1_text, "10MiB", reps=10)
        emit({"phase": "times_config1", **tc10})
        for label, res in time_split_sets(rt, words, reps=10):
            emit({"phase": "times_split", "set": label, "label": "10MB",
                  **res})
        del main_text, sp_text, c1_text
        big = make_corpus(256 << 20, seed=2, needle=b"matching",
                          density=0.01)
        t256, big_out = time_size(rt, big, "256MiB", reps=5, wall_reps=3)
        check(spans_of(big_out) == re_spans(MAIN_PATTERN, big),
              "256 MiB spans differ from re")
        emit({"phase": "times", **t256, "equal_to_re": True})
        del big_out
        emit({"phase": "times_matmul", "set": "config 3",
              **matmul_times(rt, MAIN_PATTERN, big, "256MiB", reps=3)})
        tl256 = time_literal_engines(rt, big, "256MiB", reps=5, walls=False)
        emit({"phase": "times_literal_engines", **tl256})
        emit({"phase": "scan_paths_device_s",
              **scan_paths_device_s(rt, big, "256MiB", 2)})
        del big
        big1 = make_corpus(256 << 20, seed=0, needle=b"packet",
                           density=0.002)
        check(spans_of(c1.match_all_arrays(big1)) == re_spans(
            CONFIG1_PATTERN, big1), "config 1 at 256 MiB: spans differ")
        tc256 = time_config1(rt, big1, "256MiB", reps=3)
        emit({"phase": "times_config1", **tc256, "equal_to_re": True})
        del big1
        times = {**t10, **tl10}
        for size, label, reps in ((10_000_000, "10MB", 20),
                                  (256 << 20, "256MiB", 5)):
            text = make_corpus(size, seed=2, needle=b"matching",
                               density=0.01)
            emit({"phase": "times_per_launch",
                  **time_launches(rt, text, label, reps)})
            del text
        for label, (_, pt, block) in posnfa.items():
            emit({"phase": "posnfa_launches", "pattern": label,
                  "chunk_bytes": POSNFA_CHUNK,
                  **posnfa_launches(pt, block, POSNFA_CHUNK)})
    # scan1d by the profiler, after every timing: one kernel a call.
    if not quick:
        emit({"phase": "matmul_profile", **matmul_profile(
            rt, make_corpus(10_000_000, seed=2, needle=b"matching",
                            density=0.01), 5)})
    sprof = scan_profile(scn, 20)
    emit({"phase": "scan_profile", **sprof})
    check(all(r.get("kernels_a_call") == 1 for r in sprof.values()),
          f"scan1d kernels a call: {sprof}")

    times.update(lc_times)
    kernels = []
    path_launches = {
        "literal_count": lc_launches,
        **split_launches, "schain_fused": main_launches["schain_fused"],
        "literal_spans": kw_launches["literal_spans"],
        "scan1d": sum(b3.values()),
        "schain_fused_emit_f": emit_f_row.pop("launches"),
        "gather_probe": probe_row.pop("launches"),
    }
    for k, v in emit_f_row.items():
        times["schain_fused_emit_f_" + k] = v
    for k, v in probe_row.items():
        times["gather_probe_" + k] = v
    for name in SOURCES:
        row = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": path_launches[name],
            "max_abs_err": errs[name], "equal_to_plain": errs[name] == 0,
            "ms": times.get(name + "_ms"),
            "plain_ms": times.get(name + "_plain_ms"),
            "bound_ms": times.get(name + "_bound_ms"),
            "bound_by": times.get(name + "_bound_by"),
            "library_ms": times.get(name + "_library_ms"),
            # the regex-dna Replace path's own run (strip, counts, IUB),
            # and the select phase's calls (each case, each source and
            # selection path, the first call)
            "launches_replace_path": dna_launches.get(name, 0),
            "launches_select_path": sel_launches.get(name, 0),
            # the mesh phase's counted calls: its schain_fused calls all
            # write F, so they count under schain_fused_emit_f
            "launches_mesh_path": (
                mesh_launches.get("schain_fused", 0)
                if name == "schain_fused_emit_f" else 0
                if name == "schain_fused" else mesh_launches.get(name, 0)),
        }
        kernels.append(row)
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
