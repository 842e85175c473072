"""Core paxos knobs (ref: ``gigapaxos/PaxosConfig.java`` ``PC`` enum).

The port's own copy of ``gigapaxos_tpu/paxos/paxosconfig.py``, with the
same keys and defaults except where the card differs:
``COLUMNAR_DEVICE`` defaults to ``"cuda"``, ``ENGINE_MESH`` resolves to
one device, and the reference's Pallas switch and retrace trigger have
no counterpart here (every accept on a CUDA device goes through the
hand-written kernel; torch never retraces).

Enum-keyed with typed defaults; overridable via properties file
(``GP_CONFIG=...``), ``GP_*`` env vars, or programmatic ``Config.set``
(layering per ``utils/Config.java``).
"""

from __future__ import annotations

from gigapaxos_tpu_torch.utils.config import ConfigKey


class PC(ConfigKey):
    """Paxos-core config keys; member value = typed code default."""

    # group capacity of the columnar state (rows in [G, W] device arrays)
    CAPACITY = 1 << 17
    # slot window per group (W); also the max in-flight slots per group
    WINDOW = 16
    # max packet lanes per kernel batch drained from the demux queue
    BATCH_SIZE = 4096
    # batch-fill timeout: flush a partial batch after this many seconds
    BATCH_TIMEOUT_S = 0.002
    # adaptive coalescing (SURVEY §7.3.3): when the previous batch had at
    # least BATCH_BUSY_ITEMS items (load present), the worker naps
    # BATCH_COALESCE_S after the first item of the next batch so the
    # batch fills — per-call fixed costs amortize ~10x.  Trickle traffic
    # (previous batch small) skips the nap: latency path stays hot.
    BATCH_COALESCE_S = 0.003
    BATCH_BUSY_ITEMS = 24
    # app checkpoint every this many slots per group (ref ~400)
    CHECKPOINT_INTERVAL = 400
    # backend: "columnar" (torch, CUDA kernels) or "scalar"
    # (interpreted per-instance oracle); "native" (the C++ per-instance
    # engine) is not ported yet and raises (ROADMAP module 6b)
    BACKEND = "columnar"
    # row-sharded engine lanes (columnar backend only): partition the
    # group space into this many independent lanes (shard = group_key %
    # S).  Each lane owns a ColumnarBackend slab of CAPACITY/S rows, a
    # 3-stage worker (decode-split | engine+WAL | emit), and its own
    # WAL segment wal-<k>.log with per-lane group commit — engine
    # waves, fsyncs, and emit encodes for different shards run
    # concurrently (XLA dispatch and os.fsync release the GIL, so this
    # is real multi-core parallelism).  1 = today's single-lane
    # pipeline, byte-for-byte.  Not ported yet: S > 1 raises at node
    # construction (ROADMAP module 9).
    ENGINE_SHARDS = 1
    # device-mesh columnar engine: "auto", "off" and 1 mean one device;
    # an integer N > 1 (a mesh of N devices) is not ported yet and
    # raises at node construction (ROADMAP module 16)
    ENGINE_MESH = "auto"
    # which torch device the NODE RUNTIME's columnar engine runs on:
    # "cuda" (default) or "cpu" (the tests, and any box without a
    # card).  A node asked for "cuda" on a box without one raises;
    # nothing moves to the CPU on its own.
    COLUMNAR_DEVICE = "cuda"
    # whole-wave fusion (accepts+commits / requests+replies in one
    # engine dispatch): "auto" = only on a device engine (CUDA), where
    # every dispatch pays launches and copies; "on"/"off" force it
    # either way
    FUSE_WAVES = "auto"
    # fsync WAL batches before acking accepts (the durability contract)
    SYNC_WAL = True
    # compact (GC entries below each group's checkpointed slot) when the
    # WAL grows past this many bytes; the rewrite runs on the logger's
    # writer thread, off the worker's hot path
    WAL_COMPACT_BYTES = 64 * 1024 * 1024
    # failure detection
    PING_INTERVAL_S = 0.5
    FAILURE_TIMEOUT_S = 3.0
    # deactivator (ref: DiskMap pause/unpause — the million-idle-groups
    # enabler): evict groups idle this long to the durable pause table,
    # freeing their device row; 0 disables.  Unpause is on-demand when
    # a packet arrives for a paused group.
    PAUSE_IDLE_S = 60.0
    # max groups paused per tick (bounds worker stall)
    PAUSE_MAX_PER_TICK = 256
    # max requests outstanding per client connection before pushback
    CLIENT_MAX_OUTSTANDING = 8192
    # intake rate limit (ref: paxosutil/RateLimiter): client REQUESTs
    # beyond this many per second are answered status 1 ("retry") at the
    # door instead of admitted to the pipeline; 0 disables
    MAX_INTAKE_RPS = 0
    # congestion-collapse guard (adaptive counterpart of the static rps
    # limit): when the worker's inbound queue backs up past this many
    # items, fresh client REQUESTs are answered status 1 ("retry") so
    # clients back off exponentially instead of piling retransmits onto
    # a saturated engine (observed: a closed-loop drive slightly past
    # the columnar engine's knee collapsed 850 -> 190 req/s with
    # timeouts; shedding keeps the engine at its knee).  Peer protocol
    # traffic (proposals/accepts/replies/commits) always flows.  0
    # disables.
    INTAKE_BACKLOG_LIMIT = 2048
    # two-stage worker pipeline (SURVEY §7.1 host<->device overlap, the
    # PP analog): an intake thread collects + decodes batch k+1 while
    # the process thread runs batch k's backend call + WAL fsync + sends
    # — those release the GIL (ctypes engine, XLA dispatch, fsync), so
    # decode overlaps them even on one core, and on a real accelerator
    # the device step runs concurrently with host-side batch building.
    # Off by default: on a saturated single core the second thread adds
    # GIL hand-offs on the latency path; measure per deployment
    # (testing.main throughput --pipeline prints the A/B).
    PIPELINE_WORKER = False
    # per-stage CPU-seconds accounting (DelayProfiler update_total
    # cpu column).  Off by default: thread_time() is a real syscall
    # (~6 us — no vDSO for CLOCK_THREAD_CPUTIME_ID) and the worker
    # makes ~12 of these per pass, a measurable tax on trickle batches
    PROFILE_CPU = False
    # per-request cross-stage tracing (ref: paxosutil/
    # RequestInstrumenter at FINE level): records recv/prop/acc/dec/exec
    # events into utils.instrument.RequestInstrumenter's global ring
    TRACE_REQUESTS = False
    # cluster tracing plane: fraction of client requests traced across
    # the whole deployment (0 = off, 1 = everything; 0.01 = 1%).  The
    # verdict is a deterministic hash of the req_id (= trace id), so
    # every node samples the SAME requests with zero propagated bytes;
    # a client can force one trace via the Request.FLAG_SAMPLED wire
    # bit.  Unsampled requests leave no ring entries — the hot path
    # pays one attribute check per hook.
    TRACE_SAMPLE = 0.0
    # age horizon for trace-ring entries and spans (seconds): events
    # and spans older than this are evicted, and spans whose end stamp
    # never arrived are moved to the explicit `orphaned` counter
    # instead of skewing the begun/ended pairing forever.  0 disables.
    TRACE_MAX_AGE_S = 300.0
    # slow-request log: sampled requests slower than this many seconds
    # end to end enter a bounded top-K table (0 disables), surfaced in
    # metrics()["slow_traces"] and dumped by utils/statsdump.py
    SLOW_TRACE_S = 0.0
    SLOW_TRACE_K = 32
    # observability plane (ref: the reference's periodic DelayProfiler/
    # NIOInstrumenter dumps + gigaPaxos' instrumentation endpoints):
    # STATS_PORT >= 0 starts the per-node HTTP stats listener on that
    # loopback port (0 = ephemeral; -1 = off) serving GET /metrics
    # (Prometheus text) and /stats (JSON snapshot).  Not ported yet:
    # STATS_PORT >= 0 raises at node construction (ROADMAP module 10).
    STATS_PORT = -1
    # periodic stats-line dump interval in seconds (0 = off); with
    # STATS_JSON the dumper also appends full metrics snapshots as
    # JSONL into the node's logdir
    STATS_DUMP_S = 0.0
    STATS_JSON = False
    # cluster aggregation (the gateway's /cluster/* fan-out): the
    # per-node stats listeners to scrape, as "id=host:port,id=host:
    # port".  Empty = the gateway serves only its local process view.
    STATS_PEERS = ""
    # chaos fault plane (gigapaxos_tpu/chaos/): deterministic fault
    # injection on the transport's PEER links — WAN emulation and
    # partition drills per arXiv:1404.6719's cloud pathologies.  ALL
    # defaults off; disabled costs the send path one attribute check.
    # Runtime control: GET /chaos[...] on the stats listener.  The
    # seed drives per-(src,dst)-pair PRNGs, so the k-th frame on a
    # pair meets the same fate every run — a failing chaos run
    # replays exactly (see chaos/faults.py).
    CHAOS_SEED = 0
    # base one-way delay + uniform jitter injected on every peer link
    # (a specific link: /chaos/set?src=..&dst=..)
    CHAOS_DELAY_MS = 0.0
    CHAOS_JITTER_MS = 0.0
    # probabilistic frame loss on peer links (0..1); counted under the
    # transport's distinct "chaos" drop cause
    CHAOS_DROP = 0.0
    # probability a frame is held one extra beat so later frames
    # overtake it (netem-style reorder; 0..1)
    CHAOS_REORDER = 0.0
    # boot-time partition spec "0,1|2": block both directions of every
    # edge crossing the sets (asymmetric edges: /chaos/block)
    CHAOS_PARTITION = ""
    # flight recorder (gigapaxos_tpu/blackbox/ in the JAX package):
    # bounded always-on black-box of recent ingress frames +
    # engine-wave digests + WAL offsets, dumped to
    # blackbox-<node>-<ts>.gpbb on triggers (slow trace, chaos
    # invariant violation, ballot-churn spike, SIGTERM/fatal exception,
    # GET /blackbox/dump) and re-driven offline by the blackbox replay.
    # Ring byte budget in MB; 0 = off (every hook then costs one
    # attribute check).
    BLACKBOX_MB = 0
    # age horizon for ring records in seconds (0 = bytes-only bounding)
    BLACKBOX_S = 30.0
    # auto-dump when a sampled request enters the slow-request log
    # (requires SLOW_TRACE_S > 0 and the trace plane enabled)
    BLACKBOX_ON_SLOW = False
    # wire-plane aggregation (HT-Paxos-style per-peer
    # coalescing, arXiv:1407.1237).  WIRE_COALESCE packs every frame a
    # worker batch emits toward one peer into a single FRAG super-frame
    # (delta-encoded member headers, column-compressed hot SoA bodies)
    # written with one vectorized writelines call — but only toward
    # peers that announced a compatible wire version via WIRE_HELLO;
    # un-negotiated (old) peers keep the plain per-frame path, and OFF
    # is byte-for-byte the old wire format.  Read once at node boot.
    WIRE_COALESCE = True
    # minimum same-peer frames in an emit batch worth a FRAG container
    # (below it, plain sends win — the container header costs ~10B)
    WIRE_COALESCE_MIN = 2
    # zero-copy SoA receive: deliver each read chunk as ONE WireChunk
    # (blob + offset/type columns) instead of per-frame bytes slices
    WIRE_SOA_RX = True
    # per-record CRC32 framing in the WAL (v2 frame): every appended
    # record carries a trailing checksum over header+payload, and new
    # segment files open with a GPW2 magic header.  Version-gated:
    # headerless (pre-CRC) segments replay with the old torn-tail-only
    # semantics.  A mid-segment mismatch on a v2 segment QUARANTINES
    # the segment from that record on (surfaced in /stats wal health;
    # checkpoint transfer re-syncs the affected groups) instead of
    # silently replaying garbage.  Read once at node boot.
    WAL_CRC = True
    # storage fault plane (chaos/faults.py StorageChaos): deterministic
    # fault injection on the WAL/checkpoint IO path — the disk sibling
    # of the CHAOS_* link rules, per-(node, segment) with the same
    # seeded golden-ratio replayability.  ALL defaults off; disabled
    # costs the fsync path one attribute check.  Runtime control:
    # GET /storage[...] on the stats listener.
    STORAGE_CHAOS_SEED = 0
    # probability an fsync on a WAL segment fails with EIO (0..1)
    STORAGE_CHAOS_FSYNC_EIO = 0.0
    # persistent mode: once a (node, seg) fsync fails, EVERY later
    # fsync there fails too — including on the rotated-to generation
    # (drives the declared degraded mode; transient mode exercises the
    # poison-and-rotate save)
    STORAGE_CHAOS_FSYNC_PERSIST = False
    # probability a WAL append fails with ENOSPC (disk full; 0..1)
    STORAGE_CHAOS_ENOSPC = 0.0
    # injected fsync latency: base + uniform jitter (slow-disk stall)
    STORAGE_CHAOS_FSYNC_DELAY_MS = 0.0
    STORAGE_CHAOS_FSYNC_JITTER_MS = 0.0
    # probability an append is TORN: only a prefix of the buffer
    # reaches the file (the crash-consistency shape recovery's
    # torn-tail check must absorb; 0..1)
    STORAGE_CHAOS_TORN = 0.0
    # runtime lock witness (gigapaxos_tpu/analysis/witness.py in the
    # JAX package): wrap every declared lock in a recording proxy and
    # cross-check the OBSERVED acquisition DAG against
    # decls.lock_order/leaf_locks —
    # undeclared edges and cycles fail, declared-never-observed warns.
    # Off by default (each armed acquire costs a dict probe + frame
    # peek); tier-1 arms it for the witness drill and bin/check for
    # the smoke subset.  Read once at node boot.  Not ported yet: on
    # raises at node construction (ROADMAP module 15).
    LOCK_WITNESS = False
    # where the witness drill writes its WITNESS_*.json artifact
    # ("" = artifacts/WITNESS_r01.json next to ANALYSIS_*.json)
    WITNESS_OUT = ""
