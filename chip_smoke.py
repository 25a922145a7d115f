#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``sparkucx_tpu_torch``) on one
NVIDIA H100. Run from the repository root: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero; nothing is caught and continued):

1. card   — name and power limit as nvidia-smi reports them.
2. build  — compiles every CUDA source of the port for sm_90a.
3. kernel — the ragged segment-move kernel against its plain PyTorch
            version on the card, bit-exact on every delivered segment:
            widths {1, 10, 25} x shards {1, 8} x even / skewed / one-hot /
            zero-size segments, plus a receive and a send overflow (both
            must report total -1 and zero sizes).
4. main   — the plain read through ``connect()`` at Sort Benchmark
            (TeraSort) record shape: 10,485,760 records of a 10-byte key
            and 90-byte payload, modelled as an int64 key + 23 int32
            words (100 B rows), written by 64 map tasks, 200 reduce
            partitions (Spark's default spark.sql.shuffle.partitions),
            8 logical shards, ``a2a.impl=pallas``. Every partition's
            count and (key, value) multiset is checked against a numpy
            oracle built here from the same seed. The kernel is then
            timed at the shapes this read gave it. Under the default
            ``integrity.verify=staged`` (every phase runs it) each commit
            publishes a checksum record and each read re-verifies every
            staged byte before the exchange; the line prints the
            report's ``integrity`` and ``integrity_bytes``.
5. skew   — 1,048,576 Zipf(1.1) keys under capacityFactor 0.5: the first
            attempt overflows, the regrow delivers; checked against the
            oracle as well.
6. segreduce_kernel — the segment-reduce kernel against its plain PyTorch
            version on the card: widths {3, 6, 25} x shards {1, 8} x
            all-unique keys / one key over a whole shard / runs crossing
            block edges / empty / all-sentinel shards x int32 and float32
            x sum_words from 0 through a carry split to all. Bit-exact
            for int32 and every carried lane; float32 sums within n *
            2**-24 * sum|v| of each n-row run (sequential float32
            summation's bound).
7. combine — ``read(h, combine="sum")``: 10,485,760 records from 64
            maps, int64 keys uniform over 2,097,152 ids, values int32[4]
            (a count lane of 1 and three random lanes), 200 partitions, 8
            shards, ``a2a.impl=pallas``, ``read.mergeImpl=auto``. Every
            partition's keys must be unique, sorted and its own, and
            every sum must equal a numpy int32-wrapping oracle exactly.
8. combine_f32 — the HiBench Aggregation shape (``SELECT sourceIP,
            SUM(adRevenue) FROM uservisits GROUP BY sourceIP``):
            4,194,304 rows, Zipf(1.2) keys, float32[2] values (adRevenue
            uniform in [0, 1000) summed, a per-key constant lane carried,
            ``combine_sum_words=1``). Carried lane exact; sums within
            2**-20 * sum + (rows + 1) * 2**-50 * sum|v| of a float64
            oracle.
9. ordered — TeraSort proper: the main phase's records, bounds from a
            ReservoirSampler over the written keys, ``partitioner="range"``
            and ``read(h, ordered=True)``. The concatenated partitions must
            be globally non-decreasing and each partition's (key, value)
            multiset must equal the oracle's.
10. segreduce_at_main_shapes — the sorted input the combine read gave
            the segment-reduce kernel, rebuilt from the same staging and
            plan: kernel (twice, bit-identical), its zero-tail pass alone
            (``emit_ms`` = the whole less the tail), plain version, one
            ``index_add_`` of the valid rows over precomputed run ids,
            and the byte bounds without and with the zero tail.
11. merge_kernel — the merge-path kernel against its plain PyTorch
            version on the card: widths {2, 3, 6, 25, 130} x shards {1, 8}
            x interleaved / all of A before B / equal keys on both sides
            (ties take A) / one side empty / all sentinel / keys whose lo
            high bit or hi sign differ / sizes off the block tile / an
            ``out_cap`` below ca + cb / A-only and B-only runs several
            tiles long / odd capacities (no shard base on the 16-byte
            grid) / sides at storage offsets of 1-3 words / an ``out_cap``
            inside a later tile. Bit-exact on every row and partition id.
12. waved_ordered — the ordered phase's TeraSort records and bounds with
            ``a2a.impl=dense``, ``a2a.waveRows=262144``,
            ``a2a.waveDepth=2`` (1,310,720 rows per shard: 5 waves).
            ``read(h, ordered=True, sink="device")`` must report 5 waves,
            the device sink, a merge wall and no D2H, and launch the
            merge kernel exactly 4 times (the fold: a sort-free seed from
            wave 0, then one merge per wave); its ``host_view()`` must be
            globally sorted and equal the oracle's multisets. Then the
            same read with ``sink="host"`` (the host cross-wave merge),
            held to the same oracle, and one profiled device-sink read.
13. merge_at_main_shapes — the inputs of waved_ordered's last fold step
            (the accumulator and wave 4, captured from one more read):
            kernel, plain version, ``merge_rows(impl="jnp")`` (two
            ``torch.sort`` calls and a row gather: no single PyTorch call
            merges) and the byte bound, with and without the out_cap cut;
            the kernel also 10 calls in a row, each of its two passes'
            device time (the split pre-pass, the staged tiles) and the
            host time of a call on an idle device.
14. waved_combine — the combine phase's records with the waved conf and
            ``read.mergeImpl=auto``: ``read(h, combine="sum",
            sink="device")`` launches the merge kernel 4 times and the
            segment reduce at least 9 (5 waves + 4 fold steps); every sum
            equals the int32-wrapping oracle, on the device sink's host
            view and on the host sink (``combine_packed_rows``). The
            fold's last step (captured from one more read) holds the
            merge kernel bit for bit against ``merge_plain`` and the
            segment reduce against its plain version at its own W = 6
            shapes, with the merge's time, device time per pass, byte
            bound and share of it. Then waved_combine_lossless: the host-sink read again under
            ``a2a.wire=lossless``, bit-identical to the raw one, with
            ``lossless_bytes`` > 0.
15. quant_kernel — the int8 quantize kernel against its plain version on
            the same uniforms, byte for byte: rows {1, 389, 4099, 16411}
            x widths {1, 3, 4, 128, 1000} x normal / zero rows /
            magnitudes 1e-30..1e30 / values rounding onto 127.
16. wire_reduce_kernel — the fused dequant segment reduce against its
            plain version: wire widths {1, 4, 7, 128} x shards {1, 8} x
            the segreduce_kernel patterns x a sum/carry split; keys,
            partitions, n_out and carried lanes exact, float32 sums within
            n * 2**-24 * sum|v| of each n-row run.
17. int8 — a DLRM-style embedding-gradient shuffle (MLPerf DLRM-DCNv2 on
            Criteo 1TB: embedding dimension 128, Zipf(1.05) over the
            40,000,000 ids of its largest table), 2,097,152 float32[128]
            rows from 64 maps, 200 partitions, 8 shards, each read on
            ``a2a.wire=int8`` and, for the wall and the wire bytes, on
            the raw wire: int8_plain (``a2a.impl=pallas``; keys in the
            same places as the raw read, every value within amax/127 of
            its raw row), int8_combine (``combine="sum"``, the fused
            reduce) and waved_int8_combine (``a2a.impl=dense``, 5 waves,
            device sink). Combine sums are held to one quantization step
            of every map-side partial they add (plus 2**-20 of each) of a
            float64 oracle, and the mean signed error to within 5
            standard errors of 0. Launches: quantize 1 and ragged_a2a 1;
            + segment_reduce_wire 1; quantize 5, segment_reduce_wire 5,
            merge_path 4, segment_reduce 4. The waved read's last fold
            step (captured from one more read) holds the merge kernel bit
            for bit against ``merge_plain`` on its full-width rows (W =
            130) with its time, byte bound and share, as waved_combine's.
18. quant_at_main_shapes, wire_reduce_at_main_shapes — the quantize and
            fused-reduce inputs of one more int8_combine read (captured):
            kernel, plain version, library yardstick and byte bound (the
            fused reduce as segreduce_at_main_shapes: twice, the tail
            alone, both bounds).
18b. default_conf — 393,216 TeraSort records, 64 maps, 200 partitions, 8
            shards: under the default conf (``a2a.impl=auto``) with
            ``a2a.waveRows=12288`` a ``sink="device"`` read must report
            4 waves and ``impl == "dense"`` and its host view equal the
            oracle; under ``a2a.impl=pallas`` a plain ``sink="device"``
            read (ragged_a2a 1, D2H 0) must hold each shard's rows for its
            partitions, exactly, in ``device_rows()[p, :totals[p]]``.
            Both reads print their report's ``integrity`` and
            ``integrity_bytes`` (the default staged verify).
19. flash_kernels — the three flash-attention kernels (forward, dq, dk/dv)
            against their plain versions on the card: T in {1, 33, 97,
            130, 256, 1000} x D in {8, 32, 64, 128} x causal / not x BH
            in {1, 6}, the backward kernels on the plain forward's lse and
            delta. O within 1e-4 max|O| + 1e-6, lse within 1e-5 (1 +
            |lse|), dq / dk / dv within 1e-3 max|g| + max(1e-5, 4 x the
            plain version's distance from float64).
20. ulysses_attention — one attention layer of LLaMA-2-7B-32K
            (togethercomputer/LLaMA-2-7B-32K: 32 heads of 128, full
            multi-head K/V) over its 32,768-token context, causal, batch
            1: 32,768 rows (key = position, 12,288 float32 lanes of fused
            q|k|v, standard normal from the seed), 64 maps with positions
            permuted across them, range partitions of 4,096 positions on
            8 logical shards, ``a2a.impl=pallas``, ``read(h, ordered=True,
            sink="device")`` consumed by ``ulysses_attention_consumer(8,
            4096, 32, 128, causal=True)``. D2H 0, ragged_a2a 1 and
            flash_fwd 1; the decoded q, k, v equal the written rows; O
            within the forward tolerance of the plain forward. Then one
            profiled read + consume.
21. ulysses_attention_train — the same q, k, v as leaves through
            ``ulysses_attention(q, k, v, 8, causal=True)`` and a backward
            of a seeded random cotangent: flash_fwd, flash_dq, flash_dkv 1
            each; dq, dk, dv within the grad tolerance of the plain
            backward versions.
22. ring_attention — the ring consumer at T = 8,192 (1,024 per shard,
            same width) on one device-sink read, held against the Ulysses
            consumer's O on the same rows.
23. flash_at_main_shapes — each flash kernel at the ulysses_attention
            shape ([32, 32768, 128], causal): kernel, plain version and
            the SDPA yardstick (forward; the backward of the same call for
            dq, dk, dv together), with the operation bound (split-TF32,
            and beside it float32 outside the tensor cores and TF32) and
            the byte bound; ``forward_vs_sdpa`` = the forward kernel /
            SDPA's forward, ``backward_vs_sdpa`` = (dq + dk/dv) / SDPA's
            backward.

24. workloads — every analytics runner of ``sparkucx_tpu_torch.workloads``
            on one ``connect(num_shards=8)`` under the default conf
            (``a2a.impl=auto``: the segment move for every read,
            ``read.mergeImpl=auto``: the segment reduce for every combine
            read), one after another at the sizes of ``WORKLOAD_RUNS``:
            TeraSort range and direct (10,485,760 keys, 64 maps, 200
            partitions), GroupBy, WordCount over ids and over text,
            PageRank (web-Google's 875,713 vertices and 5,105,039 edges,
            10 iterations), ALS (MovieLens-1M's shape, rank 10, 10
            iterations), SparkTC (100 vertices, 200 edges, to the
            fixpoint), q23, the skewed join and the varchar join. Each
            runner's own oracle decides; one JSON line per runner (its
            result, wall, reads, retries, launches, rows/s, peak device
            memory, the staging pool's held bytes). The segment move must
            launch once per read attempt (reads + retries) and the
            segment reduce once per combine-read attempt.
25. earlier_phases_memory_planes — every phase above, counted over
            every node's metrics while it ran: no writer spilled
            (``shuffle.spill.count`` 0) and no read waited for admission.
26. spill — main's records written by 64 maps in chunks of 8,192 rows
            under ``spill.threshold=4m`` (about four spills a map, every
            byte to sealed files), then read plain under the default conf
            (the segment move, packing from the mapped files) and held
            against the oracle; write wall, spill bytes and count, the
            read and its pack time beside main's, and a second read.
27. admission — two device-sink ``ordered=True`` reads of main's
            shuffle under main's conf (submit A, submit B, consume A, B's
            result; the segment move twice) with no cap, then under
            ``a2a.maxBytesInFlight`` of one read's
            ``_exchange_footprint``: B must defer until A is consumed and
            the capped pair's device peak fall below the uncapped pair's;
            each consumer checks its rows, key sum and order on the
            device. Then waved_ordered's device-sink read under that cap:
            its reservation beside its measured peak.
28. pipelines — ``terasort_pipeline``, ``groupby_pipeline`` (device
            sink with one warm read, then host sink) and ``join_pipeline``
            at 10,485,760 rows with a budget of a tenth of each dataset's
            bytes, under the conf ``run_workload`` derives from it, each on
            its own node under device-activity tracing: the report (oracle
            verdict, rows, per-phase walls, rounds, waves), spill and
            forced spills, the pool's peak against the budget and its
            bytes in use after (0), the launches of the segment move, the
            merge and the segment reduce (the groupby device arm: one
            segment reduce per wave and a merge plus a segment reduce per
            fold step; the first and the last launch of each held against
            the plain versions), zero D2H on the device arm, the device's
            idle share.
29. moe_train — the MoE layer of Switch-Base-8 (Fedus et al. 2021,
            google/switch-base-8: d_model 768, expert FFN 3,072, 8
            experts, top-1), capacity factor 2.0, 32,768 tokens a step (64
            sequences of 512) on a dp=2 x ep=4 grid of logical shards, on
            the raw and the int8 wire: the forward (its wall, and against
            a float64 dense top-1 oracle on the card: raw within 2e-5 +
            2e-4 |want|, int8 within 5% of max|want|), five Adam steps
            (walls, losses finite and falling, peak device bytes), the
            quantize launches (3 a step on the int8 wire: the dispatch,
            the combine and the combine's backward, each one launch for
            all 8 shards; the dispatch's backward does not run, since the
            tokens are not differentiated; none on the raw wire), the first and last quantize
            launch held byte for byte against ``quantize_plain``, and on
            the raw wire the received rows whose recomputed expert differs
            from the sender's (must be 0, with the initial and the
            trained router).
30. moe_dispatch — moe_train's tokens staged by their expert
            (``partitioner="direct"``, 8 experts as partitions, 8 maps),
            read with ``sink="device"`` under ``a2a.impl=pallas`` and
            consumed by ``make_device_dispatch_step`` over 5 fresh reads
            (read and consume walls, losses falling, D2H 0, the segment
            move once a read, its first and last launch held against the
            plain version), one device read under the default conf
            (dense) and the host-staged arm (``host_staged_consume`` on a
            host-sink read), both from the same weights as the first
            pallas read and within 1e-5 of its loss.
31. transformer_train — the five-axis MoE transformer
            (``models/transformer.py``) at Switch-Base-8's widths (vocab
            32,128, d_model 768, 12 heads of 64, d_ff 3,072, 8 experts, 12
            layers, 512-token sequences), 64 sequences a step, 2
            microbatches, capacity factor 2.0, float32, remat on,
            ``attn="ulysses"``, on ``make_mesh(8)`` (dp 1, pp 2, sp 2, tp
            1, ep 2), tokens uniform from the seed: one forward through
            the flash kernels against one through their plain versions
            (the (layer, token) routing decisions that differ, each with a
            top-2 logit gap below 1e-5 if any; logits within 2e-4 of
            max|logits| on the positions no such decision reaches; flash_fwd
            24 launches), five Adam steps at lr 1e-4 (losses finite, the
            fifth below the first; flash_fwd 48, flash_dq 24 and flash_dkv
            24 a step: the forward and remat's recompute, one each per
            layer and microbatch), the first flash_dq and flash_dkv launch
            of a step ([384, 512, 64]) against the plain backward
            (``grad_tol``), the walls, the peak device bytes, one profiled
            step and the one-hot expert products' FLOPs.
32. transformer_mesh2 — the same widths at 2 layers on ``make_mesh(8,
            order=("ep", "tp"))`` (dp 2, tp 2, ep 2), ring attention, in
            float32 and in bfloat16: the forward against the trivial
            grid's (float32 as transformer_train's check; bfloat16 with
            the trivial grid's routing replayed, the grid's own differing
            decisions below a gap of 2**-2, logits within 2e-2 of
            max|logits|), then one training step (loss finite, master
            parameters float32).
33. hier — the two-tier (ICI, DCN) read on a node of 8 shards as 2
            slices x 4 (``mesh.numSlices=2``) under the default conf
            (``a2a.topology=auto`` -> hier, ``a2a.impl=auto`` -> dense;
            no read may launch the segment move or the segment reduce),
            at main's sizes, each read printing its wall, the tier
            entries (payload and wire bytes, ``cross_exact``, the
            emulated walls), the retries and the peak device bytes:
            hier_plain (main's records against the oracle and against
            the flat read of the same shuffle, ``a2a.topology=flat``),
            hier_device (the same, ``sink="device"``: D2H 0 before
            ``host_view()``, then the oracle), hier_ordered (TeraSort
            proper, bounds from main's ReservoirSampler), hier_waved
            (the same with ``a2a.waveRows=262144``: 5 waves, each with
            ``ici_ms`` and ``dcn_ms``), hier_combine (combine's records,
            int32 sums exact) and hier_int8 (int8_plain's gradient rows
            on ``a2a.wire=int8``: quantize 2 + retries launches, the
            first and last byte-equal to ``quantize_plain``, every value
            within two rounding steps of the raw hier read's, keys in the
            same places).
34. dlpack — ``io/dlpack.ingest_foreign`` of a 1 GiB float32 tensor on
            the card (zero copy: the same data pointer) and of a 1 GiB
            CPU tensor through a pinned pool onto the card, cold (torch's
            cache of page-locked blocks emptied first) and warm, with
            GB/s; the pool's bytes in use back to 0.
35. distributed — two worker processes share the card
            (``sparkucx_tpu_torch.cluster.run_cluster``; the kernels are
            built here first, and this process's cached card memory is
            released), each holding 4 of the 8 shards under the default
            conf (``auto`` -> ``dense``; the rows that change process go
            through pinned host buffers and one gloo all-to-all), each
            writing the maps its shards own (map m to the owner of shard
            m % 8) and checking its partitions against the oracle:
            dist_plain (main's records; this process checks that every
            partition is on one worker and its digest equals main's),
            dist_hier (``mesh.numSlices=2``: the DCN stage crosses
            processes, its agreed cross rows equal the rows that change
            process), dist_waved_ordered (``a2a.waveRows=262144``,
            TeraSort bounds, the device sink with the merge fold: the
            merge kernel 4 launches a worker, then the host sink),
            dist_combine (combine's records: the segment reduce),
            dist_int8 (int8_plain's gradient rows on ``a2a.wire=int8``:
            the quantize once a worker plus once a retry, the delivered
            bytes equal to a single-process dense int8 read's) and
            dist_int8_combine (the fused dequant reduce); every
            kernel's first and last launch in each worker held against
            its plain version (``KernelCapture``). Each read prints each
            worker's wall, pack, bytes staged through the host and that
            hop's wall, retries and peak device bytes. In the same world:
            dist_replay (main's maps under ``failure.policy=replay`` with
            an ``exchange`` fault armed on both workers: each replays
            once and spends one budget unit, the digests equal main's),
            dist_full (main's maps at ``integrity.verify=full``: the
            digest tables all-gathered before the plan, both workers
            report ``integrity == "full"`` and main's digests),
            dist_decisions (on a node of its own of two slices, one a
            worker, under ``history.dir`` in a directory both workers
            share and ``trace.enabled``: main's maps read flat in waves of
            262,144 rows — the ``a2a.waveRows`` / ``a2a.waveSizes``
            rounds — and two-tier — ``tier.crossRows`` and the
            ``hier.*`` rounds; in each worker the ledger's records equal
            the ``shuffle.agreement.rounds.count`` delta; this process
            loads both ``decisions_p<rank>.jsonl``, aligns them round by
            round — one topic and one winner digest each, no audit
            finding —, holds each read's ``agreement`` summary equal in
            both workers, and merges the gathered spans through the
            gathered clock anchors into one timeline with a track a
            worker holding both reads' spans),
            dist_async (on a service of its own with
            ``tenant.asyncWorkers=4``, each worker submits the same six
            ``read_async`` reads of a minnow-sized shuffle under two
            tenants, ``lo`` normal and ``hi`` high: every result against
            the oracle, both workers run the reads in the same order,
            the concatenation of the agreed batch orders, every report's
            ``async_workers`` 4; the turnstile's waits are printed) and
            last dist_one_armed (on a node of its own under
            ``failure.collectiveTimeoutMs=6000`` and
            ``failure.replayAgreeTimeoutMs=2000``, the fault armed on
            worker 0 only: worker 0 raises ``InjectedFault`` within the
            fence, worker 1 completes or raises ``PeerLostError`` within
            twice the fence). Then dist_peer_loss: on a world of its own
            under ``failure.collectiveTimeoutMs=6000``, worker 1 is
            killed once both staged, and worker 0's read must raise
            ``PeerLostError`` within 12 s.
36. faults — the failure plane on main's, combine's and int8_plain's
            records: faults_single (main's shuffle under
            ``a2a.impl=pallas``, ``failure.policy=replay``,
            ``fault.exchange.failCount=1``: main's digests, one replay
            with its wall, the injector's (2, 1), the segment move
            launched as often as in main, the pool back to the writers'
            staging and the card's allocated bytes back to their value
            before the read), faults_ledger (a remesh to the same 8
            shards; the stale handle replays once through the recovery
            ledger, main's digests), faults_small (an eighth of main's
            records: ``replayBudget=1`` with ``failCount=5`` raises
            ``InjectedFault`` after 2 injections; ``fault.fetch.
            failCount=2`` under failfast retried to 3 fetches and 2
            ``failure.retry.ms`` observations; a ``publish`` fault at
            commit), faults_surface (main's cold read — torch's pinned
            cache emptied, a fresh node — without and with
            ``memory.preAllocateBuffers`` sized from faults_single's
            staging and pack blocks, the second also under
            ``io.fetchGranularity=partition``: node start, write and read
            walls, the pool's peak and preallocated counts,
            ``partition(0)``'s wall and D2H bytes under each granularity,
            and ``read_partitions(h, 0, 16)`` equal to ``partition(0..
            15)``), faults_waved (waved_combine's device-sink read under
            replay with ``fault.wave.failRate=0.25`` and a ``fault.seed``
            found first, on the CPU, so that the node's second read
            fails at its middle wave: the sums equal the oracle, the
            merge launches as in the fault-free read, the segment reduce
            once more per settled wave, the peak at most one wave's
            buffers above the fault-free read's) and faults_tiered
            (hier_int8's rows with ``fault.tier.dcn.failCount=1`` and the
            flight recorder on: a ``tier_fault`` naming dcn in the ring,
            one replay, partitions equal to a fault-free read's that drew
            the same int8 noise, the quantize launches of both).
37. integrity — the integrity and durability plane on main's records:
            integrity_levels (main's shuffle on a fresh ``pallas`` node at
            each of ``integrity.verify=off``, ``staged`` and ``full``,
            beside main's own read: the 64 commits' wall, the read's
            wall, pack, ``integrity`` and ``integrity_bytes``, the staged
            verify's wall and the post-exchange verify's at ``full``;
            main's digests and main's segment move launches at every
            level), integrity_corrupt (an eighth
            of main's records: ``fault.corrupt.staged.failCount=1`` under
            failfast raises ``BlockCorruptionError`` naming map 0's
            staged arena before any launch, with a ``block_corruption``
            ring event, and a clean re-read equals the oracle; the same
            fault under replay costs one replay; ``corrupt.spill`` on
            spilled writers is found through the mapped views, one
            replay, the file's crc32 as before), integrity_modes
            (waved_combine's device-sink read at ``full``: the merged
            view's key lanes sampled, ``integrity_bytes`` = staged + 8 B
            a delivered row, ``d2h_bytes`` = the sample, the merge 4 and
            the segment reduce at least 9 launches; a combine host read
            at ``full`` verifies the staged bytes only; the int8 plain
            host read at ``full`` of an eighth of int8_plain's rows
            verifies key-only digests, the quantize once; each against
            its phase's oracle) and restart_drill (a ``spawn`` child
            loads the built kernels, commits main's 64 maps under
            ``failure.ledgerDir`` and SIGKILLs itself; no ``*.tmp``, 64
            sealed ``.keys``; a fresh node recovers all 64 maps — the
            scan's wall —, adopts them, refuses a second writer, reads
            main's digests at ``staged`` with the pool's bytes in use
            unchanged; a flipped byte in map 17's ``.vals`` quarantines
            it alone at the next restart, the report names it, only it
            is written again and the read gives main's digests;
            ``unregister_shuffle`` removes the directory; the durable
            commits' wall beside main's).
38. tenancy — the multi-tenant service plane on the async read path
            (``read_async``, ``tenant.asyncWorkers=16``, main's conf):
            the whale is main's shuffle under tenant ``whale``
            (``batch``), a minnow 262,144 records of main's row shape, 8
            maps, tenant ``minnow`` (``high``), eight minnow shuffles of
            which the last is a ``combine="sum"`` read of combine's value
            shape. ``a2a.maxBytesInFlight`` is one whale read's
            footprint, measured first. tenancy_solo: the eight minnows,
            three rounds; tenancy_fair: the whale floods four
            device-sink reads into admission first (one granted and held
            until round 1's minnows are all deferred behind the other
            three, then drained and checked against main's digests; the
            rest settle as they complete, the last checked too), then the
            minnow rounds; tenancy_fifo: the same under
            ``tenant.fairShare=false``. Every minnow result against its
            oracle; the grant order through each deferred minnow's
            ``shuffle.admit.cross_grants{tenant=minnow}``: at most 1
            under DRR, exactly 3 for each of round 1's eight minnows
            under FIFO; the in-flight bytes back to 0, the queue empty,
            the pool's bytes in use back to the writers'. Printed: minnow
            p50 / p99 (queued + wall, as the reference's bench), wall,
            queued and submit-to-result, the ratios to solo beside the
            reference's CPU claim of 1.8, the whale's flood-to-last wall,
            per-tenant admitted bytes and waits, ``_pack_share`` answers,
            the pool's peak and the phase's device peak.
            tenancy_overrides: tenants ``a`` (``integrity.verify=full``)
            and ``b`` (``off``) read back to back; ``d``
            (``replayBudget=0``) under an armed exchange fault raises
            without a replay while the default tenant's read replays
            once; ``c`` (``waveDepth=1``) in a waved device-sink ordered
            read (``dense``, 4 waves) packs each wave after the previous
            one was forced and reserves less than the default depth 2.
            tenancy_quota: ``hog`` at a quota of one of its reads, three
            device-sink hog reads and a ``normal`` read: the normal one
            completes past the quota-blocked hog head while the first
            hog read still holds; every read completes.
39. telemetry — the telemetry plane on main's records:
            telemetry_trace (main's committed shuffle, ``pallas``, 8
            shards: the warm read's median of 5 with the tracer off,
            then on; each traced read's spans named as the reference's
            plain read names them, plus the port's staged
            ``shuffle.verify``, and tagged
            with its report's ``trace_id``; the span summary, each
            span's ms and share of the read's ``shuffle.exchange``
            wall; no dropped span; then one read inside
            ``tracer.device_trace`` with the tracer off (the profiler
            makes its spans live): its ``torch.profiler`` Chrome trace
            holds the segment move's kernel at least once and at most as
            often as the launch counter moved, each launched inside a
            ``shuffle.dispatch`` range), telemetry_devmon (one waved
            device-sink read of main's records at WAVE_CONF under
            ``devmon.enabled`` every 20 ms and the flight recorder: a
            sample stamped with the read's trace id, no null device
            field, ``in_use`` at most ``limit`` = the card's total
            memory, ``peak`` at least ``in_use``, the pool gauges; the
            sampled peak beside ``torch.cuda.max_memory_allocated``),
            telemetry_snapshot (``stats("prometheus")`` passes
            ``validate_exposition``, ``stats("json")``'s read-wait count
            equals the reads; the one-second history windows of
            ``history.dir`` add up to the registry's counters) and
            telemetry_flight (an eighth of main's records under an armed
            ``exchange`` fault that fires after 1.5 s: a postmortem taken
            while the read is in flight names it in
            ``in_flight_traces`` and holds spans; the read raises
            ``InjectedFault``).
40. diagnosis — the diagnosis plane on main's records (``pallas``, 8
            shards): diagnosis_anatomy (the tracer on: five warm plain
            reads, each report's ``phases`` plus ``dark_ms`` equal to
            its ``anatomy_wall_ms`` within their rounding, ``pack`` and
            ``transfer.ici`` among the phases, the ms of
            ``fold_tracer`` alone; one combine read, its ledger
            conserving too; the node's doctor then has no critical
            finding), diagnosis_drills (each on a fresh node: three
            reads under an armed ``corrupt.staged`` site fire
            ``block_corruption`` critical; a read whose exchange fails
            twice under ``failure.policy=replay`` fires
            ``replay_storm`` warn; reads under ``slo.read.p99Ms`` at
            half the anatomy's median read wall fire ``slo_burn``
            critical, ``health_status`` names ``slo_fast_burn`` and
            ``slo()["burning"]`` the objective) and diagnosis_watcher
            (``doctor.watchIntervalSecs`` 0.2, ``captureMs`` 200, the
            flight recorder: after three corrupt reads plain reads go on
            until the watcher captures; one capture, whose
            ``torch.profiler`` trace holds a segment move and whose
            postmortem carries the finding and the doctor's findings;
            a second pass captures nothing).
41. live — the network half of telemetry on main's records: a service
            under ``metrics.httpPort=0`` (an ephemeral port; the phase
            fails when the server did not bind), the tracer on, the
            decision ledger on and ``slo.read.p99Ms`` set. One main-size
            ``pallas`` read runs on a thread; while it is in flight
            ``/healthz``, ``/metrics`` and ``/snapshot`` are fetched
            (each 200, ``/healthz`` answered before the read settled,
            ``/metrics`` through ``export.validate_exposition``); after
            it settles ``/anatomy?trace=<its id>`` (its ledger's phases
            and dark time conserve its wall, and equal the report's
            stamped ledger), ``/doctor``, ``/slo`` (the objective) and
            ``/decisions`` (the ledger on), each 200; the read's
            partitions' digests equal main's. Then ``python -m
            sparkucx_tpu_torch stats --live-url URL`` and ``doctor
            --live-url URL`` run as subprocesses and must exit 0. The
            line prints each route's scrape latency beside the card's
            name and power limit.
42. facades — the slice's phases on main's records, each counting its
            own launches:
            compat_v2: ``connect`` under ``compat.version=v2`` and
            ``a2a.impl=pallas``; ``register(ShuffleDependency)``, every
            map written by attempt 0 (map 0's attempt 0 superseded,
            uncommitted, by attempt 1, whose stale handle must refuse to
            publish; a retry of committed map 1 refused), four
            ``reader(h, start, end)`` ranges over [0, 200): one segment
            move for the four, ``shuffle.read.cached.count`` 3, every
            partition's digest equal to main's; then ``read_device`` with
            no D2H before ``host_view()`` and main's digests after it.
            checkpoint: ``snapshot_shuffles`` of that service's committed
            shuffle (1.05 GB of staged rows), the service closed, a
            fresh one ``restore_shuffles`` and reads it (``pallas``;
            main's digests); then the moe_train layer (raw wire) takes
            two Adam steps, its parameters and Adam state go through a
            ``TrainCheckpointer`` save, one more step follows; a fresh
            layer restored from the save (bit for bit) takes the same
            step and must land on the same parameters and loss.
            kernelbench: ``python -m sparkucx_tpu_torch kernelbench
            --rows-log2 20 --out <tmp>`` exits 0 with all five parity
            grades ok and both kernels launched; the kernels' and the
            twins' times per case.
            workload_cli: ``python -m sparkucx_tpu_torch workload
            terasort`` at the registry's defaults exits 0 with
            ``oracle_ok``; ``{"phase": "arrow", "pyarrow": ...}`` says
            whether pyarrow imports, and where it does main's shuffle
            runs under ``io.format=arrow`` with main's digests.
            compile_cache: a child process connects with
            ``compile.cacheDir`` at the smoke's build directory and loads
            the kernel library with no nvcc build; its load time.

The distributed phase's world boots its nodes under
``metrics.httpPort=0``, so each node's fleet registry holds both
workers' URLs (one boot-time round); after the world's reads dist_fleet
has worker 0 fetch ``/cluster/snapshot`` and ``/cluster/doctor`` from its
node (``processes_answered`` 2, no missing peer), and a node pair on the
same world booted with ``metrics.httpPort=0`` and a ``failure.ledgerDir``
both workers share persists ``fleet_registry.json`` listing both of that
pair's URLs (the world's own nodes take no ledger dir: it would seal
every map commit of the dist_* reads to disk).

They run in the order card, build, kernel, segreduce_kernel,
merge_kernel, main (with its profiled read), kernel_at_main_shapes,
ordered, waved_ordered, merge_at_main_shapes, skew, combine,
segreduce_at_main_shapes, waved_combine (+ lossless), combine_f32,
quant_kernel, wire_reduce_kernel, int8, quant_at_main_shapes,
wire_reduce_at_main_shapes, default_conf, flash_kernels, ulysses_attention,
ulysses_attention_train, ring_attention, flash_at_main_shapes,
workloads, earlier_phases_memory_planes, spill, admission, pipelines,
moe_train, moe_dispatch, transformer_train, transformer_mesh2, hier,
dlpack, distributed, faults, integrity, tenancy, telemetry, diagnosis,
live, facades (compat_v2, checkpoint, kernelbench, workload_cli,
compile_cache).

Each path runs with the kernel launch counts set to 0 just before it and
read just after; a path whose kernel never launched fails (main and skew:
the segment move; combine and combine_f32: the segment move and the
segment reduce; ordered: the segment move; waved_ordered: the merge;
waved_combine: the merge and the segment reduce; the int8 paths and the
attention paths: their launch counts exactly; default_conf's pallas
read: the segment move; workloads: per runner, the segment move and the
segment reduce exactly as above; spill and admission's pairs: the segment
move; pipelines: per pipeline, the three counts exactly as above;
moe_train: the quantize exactly as above; moe_dispatch: the segment move
once a pallas read; transformer_train: the three flash kernels exactly as
above; hier_int8: the quantize exactly as above; distributed: in each
worker, per read, the merge, the segment reduce, the fused reduce and
the quantize as above; faults: the segment move in faults_single
exactly main's count, the merge and the segment reduce in faults_waved
and the quantize in faults_tiered as above; integrity: the segment move
in each level's read exactly main's count, and in every other read of
the phase once, the merge, the segment reduce and the quantize in
integrity_modes as above; tenancy: in each cell, the segment move once
an attempt of every ``pallas`` read and the segment reduce once an
attempt of every combine read, the merge once a fold step of
tenancy_overrides' waved reads; telemetry: the segment move, over the
traced reads and the device trace's read; diagnosis: the segment move
over the anatomy's plain reads and the segment move and the segment
reduce over its combine read; live: the segment move of its read;
compat_v2: the segment move once for the four readers; checkpoint: the
segment move of the restored read; kernelbench: the segment reduce and
the fused reduce in the child's cases). The
``kernels`` line gives the
launches in the faults phase (``faults_launches``) and in the integrity
phase (``integrity_launches``) of the four kernels they drive (the
segment move, the merge, the segment reduce and the quantize), and in
the tenancy phase (``tenancy_launches``) of the segment move, the merge
and the segment reduce, and in the telemetry phase
(``telemetry_launches``) of the segment move, and in the diagnosis
phase (``diagnosis_launches``) of the segment move and the segment
reduce, and in the live phase (``live_launches``) of the segment move,
and in compat_v2 (``compat_launches``) and the checkpoint's restored read
(``checkpoint_launches``) of the segment move, and in the kernelbench
child (``kernelbench_launches``) of the segment reduce and the fused
reduce; the others carry no such key. The
last two lines of standard output
are the ``kernels`` JSON object and the ``{"ok": true, "device": ...}``
object.
"""

import atexit
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20261016
RECORDS = 10_485_760
MAPS = 64
PARTITIONS = 200
SHARDS = 8
VALUE_WORDS = 23           # 90-byte payload, padded to whole int32 words
SKEW_RECORDS = 1_048_576
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
TPU_KERNEL = "sparkucx_tpu/ops/pallas/ragged_a2a.py:133"
SEG_TPU_KERNEL = "sparkucx_tpu/ops/pallas/segmented.py:377"
KERNEL_A2A = "ragged_a2a"
DEFAULT_RECORDS = 393_216  # default_conf: 49,152 rows per shard
DEFAULT_WAVE_ROWS = 12_288  # ... in 4 waves
COMBINE_IDS = 2_097_152
COMBINE_VALUE_WORDS = 4
F32_RECORDS = 4_194_304
SEG_R = 16                 # partitions of the segreduce_kernel cases
SEG_PATTERNS = ("unique", "one_key", "crossing", "empty", "sentinel")
MERGE_TPU_KERNEL = "sparkucx_tpu/ops/pallas/segmented.py:238"
# the merge's two passes (the split pre-pass, the staged tiles) by name
MERGE_DEVICE_KERNELS = ("merge_splits", "merge_tiles")
WAVE_ROWS = 262_144
WAVE_CONF = {"spark.shuffle.tpu.a2a.impl": "dense",
             "spark.shuffle.tpu.a2a.waveRows": str(WAVE_ROWS),
             "spark.shuffle.tpu.a2a.waveDepth": "2"}
MERGE_PATTERNS = ("interleaved", "a_before_b", "ties", "a_empty", "b_empty",
                  "all_sentinel", "sign_bits", "ragged", "out_cap",
                  "long_runs", "misaligned", "offset", "out_cap_mid")
MERGE_WIDTHS = (2, 3, 6, 25, 130)
# long_runs: the merged order alternates A-only and B-only runs of these
# lengths (A first): several of the kernel's tiles long, and 1-3 rows
MERGE_RUNS = (15000, 11000, 3, 21000, 7000, 1, 13000)
MERGE_OFFSET_WORDS = (1, 2, 3, 1)   # offset: storage offsets of the sides
MERGE_OUT_CAP_MID = 15240  # inside a tile of 1024, 512 and 98 rows
# (ca, na, cb, nb) of shard 0: capacities and valid rows of A and B
MERGE_SIZES = {"interleaved": (3000, 2900, 2000, 1800),
               "a_before_b": (2048, 2048, 1024, 1000),
               "ties": (2600, 2500, 2600, 2400),
               "a_empty": (512, 0, 3000, 2990), "b_empty": (3000, 3000, 0, 0),
               "all_sentinel": (1000, 0, 1500, 0),
               "sign_bits": (2000, 1900, 1800, 1700),
               "ragged": (2561, 2561, 5119, 3000),
               "out_cap": (3000, 2900, 2000, 1800),
               "long_runs": (sum(MERGE_RUNS[0::2]) + 5, sum(MERGE_RUNS[0::2]),
                             sum(MERGE_RUNS[1::2]) + 2,
                             sum(MERGE_RUNS[1::2])),
               "misaligned": (2571, 2500, 1311, 1240),
               "offset": (3001, 2900, 2003, 1800),
               "out_cap_mid": (13000, 12500, 9000, 8500)}
QUANT_TPU_KERNEL = "sparkucx_tpu/ops/pallas/quant.py:25"
QUANT_DEVICE_KERNEL = "quantize_rows"   # csrc/quant.cu's kernel symbol
QUANT_KINDS = ("normal", "zero_rows", "magnitudes", "saturate")
# the int8 cells: DLRM-style embedding gradients (MLPerf DLRM-DCNv2 on
# Criteo 1TB: embedding dimension 128, tables capped at 40M rows)
INT8_RECORDS = 2_097_152
EMB_DIM = 128
EMB_IDS = 40_000_000
INT8_WAVE_ROWS = 52_429    # 262,144 staged rows per shard -> 5 waves
# the attention cells: one attention layer of LLaMA-2-7B-32K
# (togethercomputer/LLaMA-2-7B-32K: 32 heads of 128, full multi-head K/V,
# a 32,768-token context), causal, batch 1, over 8 logical sequence shards
ATTN_HEADS = 32
ATTN_HEAD_DIM = 128
ATTN_TOKENS = 32_768
ATTN_MAPS = 64
RING_TOKENS = 8_192        # the ring consumer's depth (1,024 per shard)
FLASH_T = (1, 33, 97, 130, 256, 1000)
FLASH_D = (8, 32, 64, 128)
FP32_FLOPS_PER_S = 67e12   # H100 SXM, float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM, TF32 tensor cores, dense
# split-TF32 (3xTF32): three TF32 products for each float32-accurate one
SPLIT_TF32_FLOPS_PER_S = TF32_FLOPS_PER_S / 3
FLASH_TPU_KERNELS = {
    "flash_fwd": "sparkucx_tpu/ops/pallas/flash_attention.py:56",
    "flash_dq": "sparkucx_tpu/ops/pallas/flash_attention.py:145",
    "flash_dkv": "sparkucx_tpu/ops/pallas/flash_attention.py:186"}
SIGN_KEYS = np.array([0, 1, -1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 1 << 32,
                      -(1 << 32), (1 << 32) + 0x80000000, -(1 << 31),
                      -(1 << 31) - 1, 1 << 62, -(1 << 62), -(1 << 63),
                      (1 << 63) - 1], dtype=np.int64)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def card_device():
    import torch
    return torch.device("cuda", 0)


def median_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


# -- kernel phase ------------------------------------------------------------
def _case_sizes(kind: str, P: int, chunk: int, rng) -> np.ndarray:
    if kind == "even":
        return np.full((P, P), 300, np.int32)
    if kind == "skewed":
        s = rng.integers(0, 600, size=(P, P)).astype(np.int32)
        s[0, P - 1] = 0
        s[P // 2, P // 2] = 3000
        return s
    if kind == "onehot":
        s = np.zeros((P, P), np.int32)
        s[:, 0] = rng.integers(1, 900, size=P)
        return s
    if kind == "zero":
        return np.zeros((P, P), np.int32)
    if kind == "recv_overflow":
        return np.full((P, P), 300, np.int32)
    return np.full((P, P), 2 * chunk, np.int32)       # send_overflow


def kernel_phase(dev) -> int:
    import torch
    from sparkucx_tpu_torch.ops import ragged_a2a as ra
    rng = np.random.default_rng(SEED)
    n = 0
    # 2-10: the workloads' rows (2: TeraSort's key-only range read; 3:
    # WordCount's, PageRank's and q23's; 4: the join's and ALS's; 6:
    # GroupBy's and SparkTC's; 9: the varchar join's; 10: WordCount over
    # text); 1, 10 and 25 as the main path's phases
    for width in (1, 2, 3, 4, 6, 9, 10, 25):
        chunk = ra.chunk_rows_for(width)
        for P in (1, 8):
            for kind in ("even", "skewed", "onehot", "zero",
                         "recv_overflow", "send_overflow"):
                sizes = _case_sizes(kind, P, chunk, rng)
                cap_in = max(int(ra.align_rows(int(a.sum()), chunk))
                             for a in sizes) + P * chunk
                cap_out = int(ra.align_rows(int(sizes.sum(axis=0).max()),
                                            chunk)) + P * chunk
                if kind == "recv_overflow":
                    cap_out = chunk
                if kind == "send_overflow":
                    cap_in = chunk if P == 1 else 4 * chunk
                send = torch.from_numpy(rng.integers(
                    -(1 << 31), 1 << 31, size=(P, cap_in, width),
                    dtype=np.int64).astype(np.int32)).to(dev)
                sz = torch.from_numpy(sizes).to(dev)
                (in_off, in_sz, out_off, _, _, total_al, _, mrt,
                 mst) = ra.aligned_plan(sz, width)
                ovf = (mrt > cap_out) | (mst > cap_in)
                k = ra.ragged_a2a(send, sz, out_capacity=cap_out)
                plain_out = ra.ragged_a2a_plain(send, in_off, in_sz, out_off,
                                                ovf, cap_out)
                torch.cuda.synchronize()
                tag = f"width={width} P={P} {kind}"
                if kind.endswith("overflow"):
                    if not ((k[3] == -1).all() and (k[1] == 0).all()):
                        raise AssertionError(f"{tag}: overflow not reported")
                    n += 1
                    continue
                if not torch.equal(k[3], total_al):
                    raise AssertionError(f"{tag}: total differs")
                for q in range(P):
                    t = int(total_al[q])
                    if not torch.equal(k[0][q, :t], plain_out[q, :t]):
                        raise AssertionError(f"{tag}: receiver {q} differs")
                n += 1
    return n


# -- data and oracle ---------------------------------------------------------
def make_records(n: int, zipf: bool, seed: int):
    """(keys int64 [n], values int32 [n, 23]); value word 0 is the record
    index, so (key, word 0) is unique even when keys repeat."""
    rng = np.random.default_rng(seed)
    if zipf:
        keys = rng.zipf(1.1, n).astype(np.int64)
    else:
        keys = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                            size=n, dtype=np.int64)
    values = np.empty((n, VALUE_WORDS), np.int32)
    values[:, 0] = np.arange(n, dtype=np.int32)
    values[:, 1:] = rng.integers(-(1 << 31), 1 << 31,
                                 size=(n, VALUE_WORDS - 1), dtype=np.int64)
    return keys, values


def hash_pid(keys, R: int):
    from sparkucx_tpu_torch.shuffle.writer import hash32_np
    return (hash32_np(keys) % np.uint32(R)).astype(np.int64)


def check_against_oracle(parts, keys, values, R: int, pid=None) -> None:
    """parts[r] = (keys, values) served for partition r (a list of all R,
    or a dict of the partitions a distributed worker holds); ``pid`` the
    oracle's partition of every record (default: the hash
    partitioner)."""
    if pid is None:
        pid = hash_pid(keys, R)
    order = np.lexsort((values[:, 0], keys, pid))
    bounds = np.concatenate([[0], np.cumsum(np.bincount(pid, minlength=R))])
    for r, (gk, gv) in (parts.items() if isinstance(parts, dict)
                        else enumerate(parts)):
        lo, hi = int(bounds[r]), int(bounds[r + 1])
        if gk.shape[0] != hi - lo:
            raise AssertionError(f"partition {r}: {gk.shape[0]} rows, "
                                 f"oracle {hi - lo}")
        o = np.lexsort((gv[:, 0], gk))
        want = order[lo:hi]
        if not (np.array_equal(gk[o], keys[want])
                and np.array_equal(gv[o], values[want])):
            raise AssertionError(f"partition {r}: rows differ from oracle")


def write_maps(svc, sid: int, keys, values, num_maps: int,
               partitioner: str = "hash", bounds=None, tenant=None):
    h = svc.register_shuffle(sid, num_maps, PARTITIONS, partitioner,
                             bounds=bounds, tenant=tenant)
    per = -(-keys.shape[0] // num_maps)
    for m in range(num_maps):
        sl = slice(m * per, min((m + 1) * per, keys.shape[0]))
        svc.write(h, m, keys[sl], values[sl])
    return h


def drive_read(svc, h, **read_kw):
    """read(**read_kw) + partition(r) for every r; returns (parts,
    read_ms, views_ms)."""
    import torch
    t0 = time.perf_counter()
    res = svc.read(h, **read_kw)
    torch.cuda.synchronize()
    read_ms = (time.perf_counter() - t0) * 1e3
    t1 = time.perf_counter()
    parts = [res.partition(r) for r in range(PARTITIONS)]
    views_ms = (time.perf_counter() - t1) * 1e3
    return parts, read_ms, views_ms


# A torch.profiler trace can lack the first launches made in it, the
# more of them the longer the process has kept the card busy (all of the
# first ten after two minutes); a host wait after the profiler starts
# keeps them in most traces, not in all (tools/profiler_margin_probe.py
# measures both). Kernel times are therefore taken over PROFILER_BUSY_S
# of calls, whose first launches a trace can spare.
PROFILER_LEAD_S = 0.05
PROFILER_BUSY_S = 0.05


@contextlib.contextmanager
def device_profile(cpu: bool = True):
    """torch.profiler over the card's activity (and the host's ops with
    ``cpu``), started PROFILER_LEAD_S before the body runs."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        time.sleep(PROFILER_LEAD_S)
        yield prof


def profiled_read(svc, h, **read_kw) -> dict:
    """One more read + views under torch.profiler: device busy time by
    kernel and the device's idle share of the wall (profiler on, so the
    wall is longer than the unprofiled reads above)."""
    import torch
    with device_profile() as prof:
        parts, read_ms, views_ms = drive_read(svc, h, **read_kw)
    del parts
    wall = read_ms + views_ms
    return {"wall_ms": wall, "read_ms": read_ms, "views_ms": views_ms,
            **device_busy(prof, wall)}


def device_busy(prof, wall: float) -> dict:
    """Device busy time in a profiled window of ``wall`` ms, its idle
    share and the top device activities by name."""
    import torch
    # device-side activities only (kernels, memcpy, memset); busy time is
    # the union of their intervals, so overlap is not counted twice
    spans, by_name = [], {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s, e = evt.time_range.start, evt.time_range.end
        spans.append((s, e))
        name = evt.name[:80]
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e3
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    busy = busy_us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_busy_ms": busy,
            "device_idle_share": (1 - busy / wall) if busy else None,
            "top_device_ms": dict(top)}


def counted(name: str):
    from sparkucx_tpu_torch import backend
    got = backend.launch_counts().get(name, 0)
    if got < 1:
        raise AssertionError(f"the path never launched kernel {name}")
    return got


# -- streaming: main's read in arrival order ---------------------------------
# shard 0's copy is held behind a sleep this many times one shard's copy
# (the contract asks for at least ten)
STREAM_HOLD_COPIES = 30
# CUDA multiplexes streams onto CUDA_DEVICE_MAX_CONNECTIONS hardware
# queues (8 unless set before CUDA starts), and two streams on one queue
# wait on each other: under the default, shards s and s + 4 of a read
# shared one on the H100, so a held shard 0 also held shard 4. The proof
# that a held shard holds up no other runs in a child under CUDA's most,
# 32 queues; the smoke's own process keeps the default.
STREAM_CHILD_CONNECTIONS = "32"
STREAM_CHILD_S = 240


def sleep_cycles(dev, ms: float) -> int:
    """Cycles of ``torch.cuda._sleep`` that last at least ``ms`` at the
    SM clock the device reports (its maximum: at a lower clock the sleep
    only lasts longer)."""
    import torch
    khz = getattr(torch.cuda.get_device_properties(dev), "clock_rate", 0)
    if not khz:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(dev.index or 0),
             "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True)
        khz = float(out.stdout.split()[0]) * 1e3
    return int(math.ceil(ms * khz))


def copy_ms(dev, rows: int, width: int) -> float:
    """One D2H copy of ``rows`` x ``width`` int32 into page-locked memory,
    on CUDA events (median of 5)."""
    import torch
    src = torch.empty((rows, width), dtype=torch.int32, device=dev)
    dst = torch.empty((rows, width), dtype=torch.int32, pin_memory=True)
    return median_ms(lambda: dst.copy_(src, non_blocking=True), reps=5)


def ready_walk(res, on_first=None) -> dict:
    """Consume ``res.partitions_ready()``: the partitions, their order,
    the shards' order, and the ms to the first and the last yield."""
    parts, order, shards = {}, [], []
    t0 = time.perf_counter()
    first_ms = None
    for r, kv in res.partitions_ready():
        if first_ms is None:
            first_ms = (time.perf_counter() - t0) * 1e3
            if on_first is not None:
                on_first()
        s = int(res._part_to_shard[r])
        if not shards or shards[-1] != s:
            shards.append(s)
        order.append(r)
        parts[r] = kv
    return {"parts": parts, "order": order, "shards": shards,
            "first_ms": first_ms,
            "last_ms": (time.perf_counter() - t0) * 1e3}


def held_walk(res, cycles: int) -> dict:
    """:func:`ready_walk` over ``res`` with shard 0's copy stream held
    behind ``torch.cuda._sleep(cycles)`` (through the result's private
    seams), and whether shard 0's copy was still pending at the first
    yield (``pending_at_first``)."""
    import torch
    copies, pending = {}, []
    real_stream, real_transfer = res._shard_stream, res._shard_transfer

    def held_stream(shard, d):
        stream = real_stream(shard, d)
        if shard == 0:
            with torch.cuda.stream(stream):
                torch.cuda._sleep(cycles)
        return stream

    def captured(shard):
        copies[shard] = real_transfer(shard)
        return copies[shard]

    res._shard_stream, res._shard_transfer = held_stream, captured
    w = ready_walk(res, lambda: pending.append(not copies[0].query()))
    w["pending_at_first"] = pending[0]
    return w


def held_read(svc, h, dev) -> dict:
    """One read of ``h`` walked by :func:`held_walk` with shard 0's copy
    held for STREAM_HOLD_COPIES of one shard's copy time: the walk, its
    digests, the read's segment moves and the hold's figures."""
    import torch
    from sparkucx_tpu_torch import backend
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME
    backend.reset_launch_counts()
    t = time.perf_counter()
    res = svc.read(h)
    torch.cuda.synchronize()
    read_ms = (time.perf_counter() - t) * 1e3
    launches = backend.launch_counts().get(KERNEL_NAME, 0)
    extents = [res._runs(s).extent for s in range(SHARDS)]
    shard_copy_ms = copy_ms(dev, max(extents), 2 + VALUE_WORDS)
    w = held_walk(res, sleep_cycles(dev, STREAM_HOLD_COPIES * shard_copy_ms))
    return {"read_ms": read_ms, "launches": launches,
            "shard_copy_ms": shard_copy_ms,
            "hold_ms": STREAM_HOLD_COPIES * shard_copy_ms,
            "first_ms": w["first_ms"], "last_ms": w["last_ms"],
            "shard_order": w["shards"], "order": w["order"],
            "pending_at_first": w["pending_at_first"],
            "digests": partition_digests(w["parts"]),
            "d2h": svc.report(h.shuffle_id).d2h_bytes,
            "device_max_connections": os.environ.get(
                "CUDA_DEVICE_MAX_CONNECTIONS", "default")}


def held_child() -> int:
    """The streaming phase's child (a :class:`HeldChild`): the CUDA
    context and main's records first; at the first line on stdin, a
    fresh node that writes them and reads them once; at the second,
    :func:`held_read` of them, printed as the last line. Exits 3 when
    stdin closes first (the smoke ended)."""
    import torch
    from sparkucx_tpu_torch import backend, connect
    dev = card_device()
    torch.zeros(1, device=dev)
    keys, values = make_records(RECORDS, zipf=False, seed=SEED)
    if not sys.stdin.readline():
        return 3
    backend.kernel_library()
    with connect({"spark.shuffle.tpu.a2a.impl": "pallas"},
                 num_shards=SHARDS, use_env=False) as svc:
        h = write_maps(svc, 2, keys, values, MAPS)
        del keys, values
        # warms the step's torch ops and main's page-locked blocks, as the
        # smoke's process holds them by its held read: a cold allocation
        # of each shard's block on issue outlasts the hold
        svc.read(h)._materialize()
        if not sys.stdin.readline():
            return 3
        got = held_read(svc, h, dev)
        svc.unregister_shuffle(2)
    print(json.dumps({**got, "builds": backend.build_count()}), flush=True)
    return 0


class HeldChild:
    """:func:`held_child` in a process of its own under
    STREAM_CHILD_CONNECTIONS hardware queues. Started before the build,
    so that its own start (the interpreter, the CUDA context, main's
    records: no work on the card) is over by the streaming phase, which
    releases it in two steps (:meth:`go`, then :meth:`result`)."""

    def __init__(self):
        here = os.path.dirname(os.path.abspath(__file__))
        self._err = tempfile.TemporaryFile(mode="w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-c",
             "import sys, chip_smoke; sys.exit(chip_smoke.held_child())"],
            cwd=here, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self._err, text=True,
            env={**os.environ,
                 "CUDA_DEVICE_MAX_CONNECTIONS": STREAM_CHILD_CONNECTIONS})
        atexit.register(self.close)

    def go(self) -> None:
        try:
            self.proc.stdin.write("go\n")
            self.proc.stdin.flush()
        except BrokenPipeError:
            pass                         # result() reports the exit

    def result(self) -> dict:
        try:
            stdout, _ = self.proc.communicate("go\n", timeout=STREAM_CHILD_S)
        except BrokenPipeError:
            stdout = ""
            self.proc.wait()
        if self.proc.returncode != 0:
            self._err.seek(0)
            raise AssertionError(f"streaming: the held child exited "
                                 f"{self.proc.returncode}: "
                                 f"{self._err.read()[-3000:]}")
        return json.loads(stdout.strip().splitlines()[-1])

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self._err.close()


def streaming_phase(svc, h, dev, main_digests, index_d2h: int,
                    child: HeldChild) -> dict:
    """main's shuffle (still registered) read three more ways, and once
    in ``child``:

    * through ``partitions_ready()``: one segment move, main's digests,
      ``index_d2h`` of D2H (an index-order walk's of the same read);
    * the same with shard 0's copy stream held behind
      ``torch.cuda._sleep`` for STREAM_HOLD_COPIES of one shard's copy
      time, here under the process's CUDA default: main's digests, and
      the shards' order as it came (under the default a held queue also
      holds the shard that shares it);
    * ``partition(0)`` alone pulls shard 0's extent and nothing more,
      then the rest;
    * the held read again in the child, under STREAM_CHILD_CONNECTIONS
      queues (it writes main's records meanwhile): shard 0's partitions
      come last, its copy still pending at the first yield, main's
      digests."""
    import torch
    from sparkucx_tpu_torch import backend
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME
    t_phase = time.perf_counter()
    child.go()
    sid, width = h.shuffle_id, 2 + VALUE_WORDS
    out = {"phase": "streaming", "device_max_connections":
           os.environ.get("CUDA_DEVICE_MAX_CONNECTIONS", "default")}
    launches = 0

    def read():
        nonlocal launches
        backend.reset_launch_counts()
        t = time.perf_counter()
        res = svc.read(h)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launches += backend.launch_counts().get(KERNEL_NAME, 0)
        return res, ms

    # -- arrival order, then the index-order walk of the same read
    res, out["ready_read_ms"] = read()
    got = counted(KERNEL_NAME)
    if got != 1:
        raise AssertionError(f"streaming: {got} segment moves, want 1")
    w = ready_walk(res)
    if sorted(w["order"]) != list(range(PARTITIONS)):
        raise AssertionError("streaming: a partition missing or repeated")
    if partition_digests(w["parts"]) != main_digests:
        raise AssertionError("streaming: partitions differ from main's")
    ready_d2h = svc.report(sid).d2h_bytes
    extents = [res._runs(s).extent for s in range(SHARDS)]
    out.update({"ready_launches": got, "ready_first_ms": w["first_ms"],
                "ready_last_ms": w["last_ms"],
                "ready_shard_order": w["shards"], "ready_d2h": ready_d2h,
                "index_d2h": index_d2h, "extents": extents})
    del res, w
    if ready_d2h != index_d2h or ready_d2h != sum(extents) * width * 4:
        raise AssertionError(f"streaming: d2h {ready_d2h} (ready) against "
                             f"{index_d2h} (index order), extents "
                             f"{sum(extents) * width * 4}")

    # -- shard 0's copy stream held behind a sleep, at the CUDA default
    held = held_read(svc, h, dev)
    launches += held["launches"]
    out.update({f"default_held_{k}": held[k] for k in (
        "read_ms", "shard_copy_ms", "hold_ms", "first_ms", "last_ms",
        "shard_order", "pending_at_first")})
    if sorted(held["order"]) != list(range(PARTITIONS)) \
            or held["digests"] != main_digests:
        raise AssertionError("streaming: held read differs from main's")

    # -- partial touch: partition(0) pulls shard 0 alone
    res, out["partial_read_ms"] = read()
    res.partition(0)
    out["partial_d2h_after_0"] = svc.report(sid).d2h_bytes
    if out["partial_d2h_after_0"] != extents[0] * width * 4:
        raise AssertionError(f"streaming: partition(0) pulled "
                             f"{out['partial_d2h_after_0']} B, shard 0 "
                             f"holds {extents[0] * width * 4}")
    parts = [res.partition(r) for r in range(PARTITIONS)]
    out["partial_d2h_after_all"] = svc.report(sid).d2h_bytes
    if out["partial_d2h_after_all"] != ready_d2h \
            or partition_digests(parts) != main_digests:
        raise AssertionError("streaming: the rest of the partial walk "
                             "differs")
    del res, parts

    # -- the held read in the child, each copy stream on a queue of its own
    t = time.perf_counter()
    held = child.result()
    out["child_wait_s"] = time.perf_counter() - t
    launches += held["launches"]
    slow = list(range(PARTITIONS // SHARDS))        # shard 0's partitions
    out.update({f"held_{k}": held[k] for k in (
        "read_ms", "shard_copy_ms", "hold_ms", "first_ms", "last_ms",
        "shard_order", "pending_at_first", "launches", "d2h",
        "device_max_connections", "builds")})
    out["held_last_partitions"] = held["order"][-len(slow):]
    if held["launches"] != 1 or held["builds"] != 0:
        raise AssertionError(f"streaming: the child made {held['launches']}"
                             f" segment moves and {held['builds']} builds")
    if not held["pending_at_first"]:
        raise AssertionError(f"streaming: shard 0's copy had landed by the "
                             f"first yield ({held['first_ms']} ms, hold "
                             f"{held['hold_ms']} ms, shards "
                             f"{held['shard_order']}); the hold did not "
                             f"hold")
    if held["order"][-len(slow):] != slow or held["shard_order"][-1] != 0:
        raise AssertionError(f"streaming: shard 0's partitions not last: "
                             f"shards {held['shard_order']}")
    if sorted(held["order"]) != list(range(PARTITIONS)) \
            or held["digests"] != main_digests or held["d2h"] != ready_d2h:
        raise AssertionError("streaming: the child's held read differs "
                             "from main's")
    out.update({"launches": launches, "ok": True,
                "seconds": time.perf_counter() - t_phase})
    return out


# -- kernel at the main path's shapes ----------------------------------------
def kernel_at_main_shapes(keys, values, rep, dev) -> dict:
    """Rebuild the exact segment-move inputs the main read gave the kernel
    (same staging, plan and aligned sort), check kernel == plain == one
    index_select over the same segments, and time all three."""
    import torch
    from sparkucx_tpu_torch.ops import ragged_a2a as ra
    from sparkucx_tpu_torch.shuffle.plan import ShufflePlan
    from sparkucx_tpu_torch.shuffle.reader import aligned_send, pack_rows
    cap_in, cap_out = rep.plan_bucket
    cap_out *= 2 ** rep.retries
    width = 2 + VALUE_WORDS
    per = -(-keys.shape[0] // MAPS)
    rows = np.zeros((SHARDS, cap_in, width), np.int32)
    nvalid = np.zeros(SHARDS, np.int32)
    for m in range(MAPS):                      # map_id % P, map order
        p = m % SHARDS
        sl = slice(m * per, min((m + 1) * per, keys.shape[0]))
        n = sl.stop - sl.start
        pack_rows(keys[sl], values[sl], width,
                  out=rows[p, nvalid[p]:nvalid[p] + n])
        nvalid[p] += n
    plan = ShufflePlan(SHARDS, PARTITIONS, cap_in, cap_out, "pallas")
    payload = torch.from_numpy(rows).to(dev)
    srows, _, dev_counts, cap_eff = aligned_send(
        plan, payload, torch.from_numpy(nvalid).to(dev))
    del payload
    (in_off, in_sz, out_off, recv_sz, recv_off, total_al, _, mrt,
     mst) = ra.aligned_plan(dev_counts, width)
    ovf = (mrt > cap_eff) | (mst > srows.shape[1])
    if bool(ovf):
        raise AssertionError("main-path shapes overflow on replay")

    # one gather over the same segments, receiver-major (the library
    # call's layout is the concatenation of every receiver's prefix)
    io, isz, ro = (in_off.cpu().numpy(), in_sz.cpu().numpy(),
                   recv_off.cpu().numpy())
    idx = np.concatenate([
        np.arange(isz[i, j], dtype=np.int64) + io[i, j] + i * srows.shape[1]
        for j in range(SHARDS) for i in range(SHARDS)])
    src_idx = torch.from_numpy(idx).to(dev)
    flat = srows.view(-1, width)

    def kernel():
        return ra.ragged_a2a_kernel(srows, in_off, in_sz, out_off, ovf,
                                    cap_eff)

    def plain():
        return ra.ragged_a2a_plain(srows, in_off, in_sz, out_off, ovf,
                                   cap_eff)

    def library():
        return flat.index_select(0, src_idx)

    k, p, lib = kernel(), plain(), library()
    torch.cuda.synchronize()
    tot = total_al.cpu().numpy()
    err = 0
    compact = []
    for q in range(SHARDS):
        a, b = k[q, :tot[q]], p[q, :tot[q]]
        err = max(err, int((a.long() - b.long()).abs().max()) if tot[q]
                  else 0)
        compact.append(a)
    if err or not torch.equal(torch.cat(compact), lib):
        raise AssertionError(f"kernel disagrees at main shapes (err {err})")
    del k, p, lib, compact
    moved = int(in_sz.sum()) * width * 4
    out = {
        "kernel_ms": median_ms(kernel),
        "plain_ms": median_ms(plain, reps=5, warmup=1),
        "library_ms": median_ms(library),
        "bound_ms": 2 * moved / HBM_BYTES_PER_S * 1e3,
        "max_abs_err": err,
        "moved_bytes": moved,
        "send_shape": list(srows.shape),
        "cap_eff": cap_eff,
        "recv_sz_max": int(recv_sz.sum(dim=1).max()),
    }
    return out

# -- segment-reduce kernel phase ---------------------------------------------
def _seg_shard(rng, cap: int, width: int, pattern: str, dtype: str):
    """One shard's (rows [cap, W], part [cap]) sorted by (partition, key):
    all-unique keys with a sentinel tail; one key over every row (a run
    longer than any block); runs of 1..600 rows across block edges; an
    empty shard (zero rows, all sentinel); an all-sentinel shard whose
    rows hold data the reduce must ignore."""
    rows = rng.integers(-(1 << 31), 1 << 31, (cap, width)).astype(np.int32)
    if dtype == "float32":
        rows[:, 2:] = rng.standard_normal((cap, width - 2)).astype(
            np.float32).view(np.int32)
    part = np.full(cap, SEG_R, np.int32)
    if pattern == "empty":
        return np.zeros_like(rows), part
    if pattern == "sentinel":
        return rows, part
    n_real = cap - cap // 7 if pattern == "unique" else cap
    if pattern == "unique":
        keys = rng.choice(1 << 40, n_real, replace=False).astype(np.int64)
        p = rng.integers(0, SEG_R, n_real)
    elif pattern == "one_key":
        keys = np.full(n_real, -(1 << 35) - 3, np.int64)
        p = np.full(n_real, 3)
    else:
        keys = np.repeat(rng.integers(-(1 << 40), 1 << 40, n_real),
                         rng.integers(1, 600, n_real))[:n_real]
        p = keys % SEG_R                   # a key lives in one partition
    order = np.lexsort((keys, p))
    rows[:n_real, :2] = keys[order].view(np.int32).reshape(n_real, 2)
    part[:n_real] = p[order]
    return rows, part


def run_tolerance(rows, part, sum_words: int,
                  num_parts: int = SEG_R) -> np.ndarray:
    """[P, cap, sum_words]: for output row j (run j), n * 2**-24 * sum|v|
    over the run's n rows — the bound of sequential float32 summation
    (the kernel adds a run in row order in float32; the plain version
    adds in float64 and rounds once)."""
    P, cap, _ = rows.shape
    key = rows[..., :2].copy().view(np.int64)[..., 0]
    tol = np.zeros((P, cap, sum_words))
    for p in range(P):
        valid = part[p] < num_parts
        start = valid.copy()
        start[1:] &= (key[p, 1:] != key[p, :-1]) | (part[p, 1:]
                                                    != part[p, :-1])
        run = (np.cumsum(start) - 1)[valid]
        v = np.abs(rows[p, :, 2:2 + sum_words].copy().view(np.float32)
                   .astype(np.float64))[valid]
        n = np.bincount(run, minlength=cap)[:cap]
        for c in range(sum_words):
            tol[p, :, c] = n * 2.0 ** -24 * np.bincount(
                run, weights=v[:, c], minlength=cap)[:cap]
    return tol


def segreduce_kernel_phase(dev) -> dict:
    import torch
    from sparkucx_tpu_torch.ops import segmented as sg
    rng = np.random.default_rng(SEED + 3)
    n, f32_err = 0, 0.0
    for width in (3, 6, 10, 25):
        for P in (1, 8):
            cap = 2000 if P == 8 else 5000
            for i, pattern in enumerate(SEG_PATTERNS):
                # with 8 shards the others cycle through the other patterns
                pats = [SEG_PATTERNS[(i + s) % len(SEG_PATTERNS)]
                        for s in range(P)]
                for dtype in ("int32", "float32"):
                    shards = [_seg_shard(rng, cap, width, q, dtype)
                              for q in pats]
                    rows_np = np.stack([x[0] for x in shards])
                    part_np = np.stack([x[1] for x in shards])
                    rows = torch.from_numpy(rows_np).to(dev)
                    part = torch.from_numpy(part_np).to(dev)
                    fa = dtype == "float32"
                    vw = width - 2
                    # one summed word beside carried ones: the word
                    # counts of WordCount over text (width 10)
                    for sw in sorted({0, 1, vw // 2, vw}):
                        got = sg.segment_reduce_kernel(
                            rows, part, SEG_R, sw, fa)
                        tag = (f"width={width} P={P} {pattern} {dtype} "
                               f"sum_words={sw}")
                        f32_err = max(f32_err, check_segment_reduce(
                            tag, (rows, part, SEG_R, sw, fa), got))
                        n += 1
    return {"cases": n, "f32_max_abs_err": f32_err}


def check_segment_reduce(tag: str, args, got) -> float:
    """Hold the kernel's (rows, part, n_out) for ``args`` = (rows, part,
    num_parts, sum_words, float_acc) against the plain version on the
    same inputs: counts, partitions, keys and carried words exact; integer
    sums exact; float32 sums within :func:`run_tolerance`. Returns the
    float sums' largest difference (0 for integer sums)."""
    import torch
    from sparkucx_tpu_torch.ops import segmented as sg
    rows, part, num_parts, sw, fa = args
    kr, kp, kn = got
    pr, pp, pn = sg.segment_reduce_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(kn, pn) and torch.equal(kp, pp)):
        raise AssertionError(f"{tag}: n_out/part differ")
    exact = [0, 1] + list(range(2 + sw, rows.shape[2]))
    if not torch.equal(kr[..., exact], pr[..., exact]):
        raise AssertionError(f"{tag}: keys/carry differ")
    if not fa and not torch.equal(kr, pr):
        raise AssertionError(f"{tag}: sums differ")
    if not (fa and sw):
        return 0.0
    k = kr[..., 2:2 + sw].contiguous().view(torch.float32).double()
    p = pr[..., 2:2 + sw].contiguous().view(torch.float32).double()
    diff = (k - p).abs().cpu().numpy()
    if (diff > run_tolerance(rows.cpu().numpy(), part.cpu().numpy(), sw,
                             num_parts)).any():
        raise AssertionError(f"{tag}: float sums outside tolerance")
    return float(diff.max()) if diff.size else 0.0


def check_segment_reduce_wire(tag: str, args, got) -> float:
    """Hold the fused dequant reduce's (rows, part, n_out) for ``args`` =
    (wire rows, part, num_parts, width, wire_words, sum_words) against
    ``segment_reduce_wire_plain``: counts, partitions, keys and carried
    lanes exact, float32 sums within :func:`run_tolerance` of the
    dequantized rows. Returns the sums' largest difference."""
    import torch
    from sparkucx_tpu_torch.ops import segmented as sg
    from sparkucx_tpu_torch.shuffle.alltoall import wire_unpack_rows
    rows, part, num_parts, width, ww, sw = args
    kr, kp, kn = got
    pr, pp, pn = sg.segment_reduce_wire_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(kn, pn) and torch.equal(kp, pp)):
        raise AssertionError(f"{tag}: n_out/part differ")
    exact = [0, 1] + list(range(2 + sw, width))
    if not torch.equal(kr[..., exact], pr[..., exact]):
        raise AssertionError(f"{tag}: keys/carry differ")
    k = kr[..., 2:2 + sw].contiguous().view(torch.float32).double()
    p = pr[..., 2:2 + sw].contiguous().view(torch.float32).double()
    diff = (k - p).abs().cpu().numpy()
    full = wire_unpack_rows(rows, width, ww).cpu().numpy()
    if (diff > run_tolerance(full, part.cpu().numpy(), sw,
                             num_parts)).any():
        raise AssertionError(f"{tag}: float sums outside tolerance")
    return float(diff.max()) if diff.size else 0.0


# -- combine and ordered reads -----------------------------------------------
def make_combine_records(n: int, seed: int):
    """(keys int64 [n] uniform over COMBINE_IDS ids, both signs and both
    key words; values int32 [n, 4]: a count lane of 1, three random)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, COMBINE_IDS, n)
    keys = (ids - COMBINE_IDS // 2) * 1_000_000_007
    values = np.empty((n, COMBINE_VALUE_WORDS), np.int32)
    values[:, 0] = 1
    values[:, 1:] = rng.integers(-(1 << 31), 1 << 31,
                                 size=(n, COMBINE_VALUE_WORDS - 1),
                                 dtype=np.int64)
    return keys, values


def make_uservisits(n: int, seed: int):
    """(sourceIP keys int64 Zipf(1.2), values float32 [n, 2]: adRevenue
    uniform in [0, 1000), then a per-key constant lane)."""
    rng = np.random.default_rng(seed)
    keys = rng.zipf(1.2, n).astype(np.int64)
    values = np.empty((n, 2), np.float32)
    values[:, 0] = rng.uniform(0, 1000, n)
    values[:, 1] = (keys % 65521).astype(np.float32)
    return keys, values


def group_oracle(keys, values):
    """(unique keys, float64/int64 per-key sums, per-key row counts)."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
    wide = np.float64 if values.dtype.kind == "f" else np.int64
    sums = np.add.reduceat(values[order].astype(wide), starts, axis=0)
    counts = np.diff(np.r_[starts, sk.size])
    return sk[starts], sums, counts


def combined_rows(parts, R: int, pid_of):
    """Check every partition's keys are unique, ascending and its own;
    return (keys, values) of all partitions in key order."""
    ks, vs = [], []
    for r in range(R):
        gk, gv = parts[r]
        if gk.size and (np.diff(gk) <= 0).any():
            raise AssertionError(f"partition {r}: keys not unique+sorted")
        if gk.size and (pid_of(gk) != r).any():
            raise AssertionError(f"partition {r}: holds another's keys")
        ks.append(gk)
        vs.append(gv)
    k, v = np.concatenate(ks), np.concatenate(vs)
    o = np.argsort(k, kind="stable")
    return k[o], v[o]


def device_read(svc, h, dev, kernels, **read_kw):
    """One measured read: launch counts and peak memory reset just
    before, every kernel of ``kernels`` must have launched."""
    import torch
    from sparkucx_tpu_torch import backend
    torch.cuda.reset_peak_memory_stats(dev)
    backend.reset_launch_counts()
    parts, read_ms, views_ms = drive_read(svc, h, **read_kw)
    launches = {k: counted(k) for k in kernels}
    counts = backend.launch_counts()
    return parts, {"read_ms": read_ms, "views_ms": views_ms,
                   "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
                   "launches": launches, "all_launches": counts}


def warm_read(svc, sid: int, keys, values, **read_kw) -> None:
    """A small read of the same kind first (not counted, not timed)."""
    drive_read(svc, write_maps(svc, sid, keys, values, 8), **read_kw)
    svc.unregister_shuffle(sid)


def combine_phase(dev, conf) -> tuple:
    from sparkucx_tpu_torch import connect
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME
    from sparkucx_tpu_torch.ops.segmented import KERNEL_NAME as SEG
    t = time.perf_counter()
    keys, values = make_combine_records(RECORDS, SEED + 4)
    gen_s = time.perf_counter() - t
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        wk, wv = make_combine_records(1 << 16, SEED + 5)
        warm_read(svc, 10, wk, wv, combine="sum")
        h = write_maps(svc, 11, keys, values, MAPS)
        parts, stats = device_read(svc, h, dev, (KERNEL_NAME, SEG),
                                   combine="sum")
        rep = svc.report(11)
        # steady state: the same read again, then once under the profiler
        _, read2_ms, views2_ms = drive_read(svc, h, combine="sum")
        rep2 = svc.report(11)
        prof = profiled_read(svc, h, combine="sum")
        svc.unregister_shuffle(11)
    if rep.kernel != "pallas":
        raise AssertionError(f"combine read ran kernel tier {rep.kernel}")
    t = time.perf_counter()
    uk, sums, _ = group_oracle(keys, values)
    gk, gv = combined_rows(parts, PARTITIONS,
                           lambda k: hash_pid(k, PARTITIONS))
    want = (sums & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    if not (np.array_equal(gk, uk) and np.array_equal(gv, want)):
        raise AssertionError("combine: keys or sums differ from the oracle")
    check_s = time.perf_counter() - t
    part_rows = [int(parts[r][0].shape[0]) for r in range(PARTITIONS)]
    out = {"phase": "combine", "records": RECORDS, "maps": MAPS,
           "partitions": PARTITIONS, "shards": SHARDS, "impl": rep.impl,
           "kernel": rep.kernel, "rows_out": int(uk.size),
           "retries": rep.retries, "plan_bucket": rep.plan_bucket,
           "pack_ms": rep.pack_ms, "dispatch_ms": rep.dispatch_ms,
           "group_ms": rep.group_ms, **stats, "read2_ms": read2_ms,
           "views2_ms": views2_ms, "read2_pack_ms": rep2.pack_ms,
           "read2_dispatch_ms": rep2.dispatch_ms, "gen_s": gen_s,
           "oracle_s": check_s, "ok": True}
    return out, prof, rep, keys, values, part_rows


def combine_f32_phase(dev, conf) -> dict:
    from sparkucx_tpu_torch import connect
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME
    from sparkucx_tpu_torch.ops.segmented import KERNEL_NAME as SEG
    keys, values = make_uservisits(F32_RECORDS, SEED + 6)
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        wk, wv = make_uservisits(1 << 16, SEED + 7)
        warm_read(svc, 12, wk, wv, combine="sum", combine_sum_words=1)
        h = write_maps(svc, 13, keys, values, MAPS)
        parts, stats = device_read(svc, h, dev, (KERNEL_NAME, SEG),
                                   combine="sum", combine_sum_words=1)
        rep = svc.report(13)
        _, read2_ms, views2_ms = drive_read(svc, h, combine="sum",
                                            combine_sum_words=1)
        svc.unregister_shuffle(13)
    if rep.kernel != "pallas":
        raise AssertionError(f"combine_f32 read ran kernel {rep.kernel}")
    uk, sums, counts = group_oracle(keys, values)
    gk, gv = combined_rows(parts, PARTITIONS,
                           lambda k: hash_pid(k, PARTITIONS))
    if not np.array_equal(gk, uk):
        raise AssertionError("combine_f32: keys differ from the oracle")
    if not np.array_equal(gv[:, 1], (uk % 65521).astype(np.float32)):
        raise AssertionError("combine_f32: the carried lane changed")
    # map-side float64 prefix differences (each off by at most 2**-53 of
    # the running prefix per row) rounded to float32, then at most 8
    # shard partials added in float32 by the kernel
    total = float(np.abs(values[:, 0].astype(np.float64)).sum())
    tol = 2.0 ** -20 * sums[:, 0] + (counts + 1) * 2.0 ** -50 * total
    err = np.abs(gv[:, 0].astype(np.float64) - sums[:, 0])
    if (err > tol).any():
        raise AssertionError(f"combine_f32: sums outside tolerance "
                             f"(worst {float((err / tol).max())} x tol)")
    return {"phase": "combine_f32", "records": F32_RECORDS,
            "rows_out": int(uk.size), "hot_key_rows": int(counts.max()),
            "max_abs_err": float(err.max()),
            "max_rel_err": float((err / sums[:, 0]).max()),
            "retries": rep.retries, "plan_bucket": rep.plan_bucket,
            "kernel": rep.kernel, **stats, "read2_ms": read2_ms,
            "views2_ms": views2_ms, "ok": True}


def terasort_bounds(keys) -> np.ndarray:
    """Range bounds from a ReservoirSampler over every map's keys."""
    from sparkucx_tpu_torch.ops.partition import ReservoirSampler
    sampler = ReservoirSampler(capacity=1 << 16, seed=SEED)
    per = -(-keys.shape[0] // MAPS)
    for m in range(MAPS):
        sampler.add(keys[m * per:(m + 1) * per])
    return sampler.bounds(PARTITIONS)


def ordered_phase(dev, conf, keys, values) -> tuple:
    """TeraSort proper over the main phase's records."""
    from sparkucx_tpu_torch import connect
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME
    from sparkucx_tpu_torch.ops.segmented import KERNEL_NAME as SEG
    bounds = terasort_bounds(keys)
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        h = write_maps(svc, 14, keys, values, MAPS, "range", bounds)
        parts, stats = device_read(svc, h, dev, (KERNEL_NAME,),
                                   ordered=True)
        rep = svc.report(14)
        prof = profiled_read(svc, h, ordered=True)
        svc.unregister_shuffle(14)
    if stats["all_launches"].get(SEG, 0):
        raise AssertionError("the ordered read ran the segment reduce")
    t = time.perf_counter()
    allk = np.concatenate([parts[r][0] for r in range(PARTITIONS)])
    if allk.size != keys.size or (np.diff(allk) < 0).any():
        raise AssertionError("ordered: partitions not globally sorted")
    del allk
    pid = np.searchsorted(bounds, keys, side="right").astype(np.int64)
    check_against_oracle(parts, keys, values, PARTITIONS, pid=pid)
    sizes = np.bincount(pid, minlength=PARTITIONS)
    return {"phase": "ordered", "records": int(keys.size),
            "impl": rep.impl, "retries": rep.retries,
            "plan_bucket": rep.plan_bucket,
            "partition_rows_min_max": [int(sizes.min()), int(sizes.max())],
            **stats, "oracle_s": time.perf_counter() - t, "ok": True}, prof


def segreduce_at_main_shapes(keys, values, rep, part_rows, dev) -> dict:
    """Rebuild the sorted input the combine read gave the segment-reduce
    kernel (same staging, plan, segment move, densify and keysort), check
    kernel == plain == one index_add_ over precomputed run ids, and time
    all three beside the byte bound."""
    import torch
    from sparkucx_tpu_torch.ops import segmented as sg
    from sparkucx_tpu_torch.ops.aggregate import keysort_rows
    from sparkucx_tpu_torch.ops.partition import (counts_from_sorted,
                                                  words_to_key)
    from sparkucx_tpu_torch.shuffle.plan import ShufflePlan
    from sparkucx_tpu_torch.shuffle.reader import (densified_receive,
                                                   pack_rows)
    cap_in, cap_out = rep.plan_bucket
    cap_out *= 2 ** rep.retries
    vw = COMBINE_VALUE_WORDS
    width = 2 + vw
    per = -(-keys.shape[0] // MAPS)
    rows = np.zeros((SHARDS, cap_in, width), np.int32)
    nvalid = np.zeros(SHARDS, np.int32)
    for m in range(MAPS):                      # map_id % P, map order
        p = m % SHARDS
        sl = slice(m * per, min((m + 1) * per, keys.shape[0]))
        n = sl.stop - sl.start
        pack_rows(keys[sl], values[sl], width,
                  out=rows[p, nvalid[p]:nvalid[p] + n])
        nvalid[p] += n
    plan = ShufflePlan(SHARDS, PARTITIONS, cap_in, cap_out, "pallas",
                       combine="sum", combine_words=vw,
                       combine_dtype=np.dtype(np.int32).str,
                       kernel_impl="pallas")
    out, pkey, ovf = densified_receive(
        plan, torch.from_numpy(rows).to(dev), torch.from_numpy(nvalid).to(dev))
    if bool(ovf):
        raise AssertionError("combine shapes overflow on replay")
    spart, srows, _ = keysort_rows(out, pkey, out.shape[1], PARTITIONS)
    del out, pkey
    P, cap, _ = srows.shape

    def kernel():
        return sg.segment_reduce_kernel(srows, spart, PARTITIONS, vw, False)

    def plain():
        return sg.segment_reduce_plain(srows, spart, PARTITIONS, vw, False)

    # the library call: one index_add_ of the valid rows' summed lanes
    # into their run slots (run ids and the valid-row selection are
    # precomputed, outside the timed call)
    valid = spart < PARTITIONS
    key = words_to_key(srows[..., 0], srows[..., 1])
    same = torch.zeros_like(valid)
    same[:, 1:] = (key[:, 1:] == key[:, :-1]) & (spart[:, 1:]
                                                 == spart[:, :-1])
    run = torch.cumsum(valid & ~same, dim=1) - 1
    base = torch.arange(P, device=dev)[:, None] * cap
    dest = (run + base)[valid]
    lanes = srows[..., 2:2 + vw][valid].contiguous()
    acc = torch.zeros((P * cap, vw), dtype=torch.int32, device=dev)
    del key, same, run, base, valid

    def library():
        return acc.index_add_(0, dest, lanes)

    kr, kp, kn = kernel()
    pr, pp, pn = plain()
    library()
    torch.cuda.synchronize()
    err = int((kr.long() - pr.long()).abs().max())
    if err or not (torch.equal(kn, pn) and torch.equal(kp, pp)):
        raise AssertionError(f"segment reduce disagrees at main shapes "
                             f"(err {err})")
    if not torch.equal(acc.reshape(P, cap, vw), kr[..., 2:]):
        raise AssertionError("index_add_ disagrees with the kernel")
    again = kernel()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(again, (kr, kp, kn))):
        raise AssertionError("two launches of the segment reduce differ")
    del again
    pcounts = counts_from_sorted(kp, PARTITIONS).sum(dim=0)
    if pcounts.cpu().tolist() != part_rows:
        raise AssertionError("replayed input is not the combine read's")
    valid = int((spart < PARTITIONS).sum())
    n_out = int(kn.sum())
    del pr, pp
    times = reduce_times(kernel, plain, library, kr, kp, kn, PARTITIONS)
    return {**times, **reduce_bounds(P, cap, width, width, valid, n_out,
                                     times),
            "max_abs_err": err, "input_shape": [P, cap, width],
            "valid_rows": valid, "n_out": n_out}


def reduce_times(kernel, plain, library, out_rows, out_part, n_out,
                 num_parts) -> dict:
    """Medians of the whole kernel (tile pass + tail), its tail pass alone
    (in place on the kernel's own output), the plain version and the
    library call, each one call between CUDA events; ``emit_ms`` is the
    whole less the tail. Beside them, the whole in back-to-back calls and
    each pass's device time from the profiler."""
    from sparkucx_tpu_torch.ops import segmented as sg

    def tail():
        sg.segment_reduce_tail_kernel(out_rows, out_part, n_out, num_parts)

    kernel_ms = median_ms(kernel)
    tail_ms = median_ms(tail)
    library_ms = median_ms(library)
    dev = device_kernel_ms(kernel, ("reduce_tiles", "zero_tail"))
    return {"kernel_ms": kernel_ms, "tail_ms": tail_ms,
            "back_to_back_ms": back_to_back_ms(kernel),
            "emit_ms": kernel_ms - tail_ms,
            "plain_ms": median_ms(plain, reps=5, warmup=1),
            "library_ms": library_ms,
            "factor_vs_library": kernel_ms / library_ms,
            "emit_factor_vs_library": (kernel_ms - tail_ms) / library_ms,
            "device_ms": dev,
            "device_emit_factor_vs_library": dev["reduce_tiles"]
            / library_ms}


def device_kernel_ms(fn, names, calls: int = 5) -> dict:
    """Device time per call of each kernel whose name holds one of
    ``names``: the mean over the launches that a torch.profiler trace of
    at least ``calls`` calls of ``fn``, and PROFILER_BUSY_S of them,
    holds (the CUDA-event times above also hold the wrapper's host work
    whenever the device waits for it)."""
    import torch
    fn()
    torch.cuda.synchronize()
    with device_profile() as prof:
        made, t0 = 0, time.perf_counter()
        while made < calls or time.perf_counter() - t0 < PROFILER_BUSY_S:
            fn()
            made += 1
            if made % calls == 0:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
    spans = {name: [] for name in names}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name in names:
            if name in evt.name:
                spans[name].append((evt.time_range.end
                                    - evt.time_range.start) / 1e3)
    if not all(spans.values()):
        raise AssertionError(f"the profiler saw no launch of {names} in "
                             f"{made} calls")
    return {**{name: float(np.mean(v)) for name, v in spans.items()},
            "calls": made,
            "launches_seen": {name: len(v) for name, v in spans.items()}}


def host_ms(fn, reps: int = 7) -> float:
    """Median host wall of one call on an idle device: the wrapper's
    checks, allocations and launches, which a lone call between CUDA
    events makes the device wait for."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def back_to_back_ms(fn, calls: int = 10) -> float:
    """CUDA events around ``calls`` calls in a row, over the count
    (median of 3): the host queues the next call while the device runs
    this one, so the wrapper's host work hides behind the kernel."""
    def run():
        for _ in range(calls):
            fn()
    return median_ms(run, reps=3, warmup=1) / calls


def reduce_bounds(P: int, cap: int, width_in: int, width: int, valid: int,
                  n_out: int, times: dict) -> dict:
    """The segment reduce's byte bounds at 3.35 TB/s. What this input
    needs: every row's partition and every valid row's words read once,
    the n_out run rows and their partitions written (``bound_ms``); with
    the zero tail, rows n_out..cap and their partitions written as well
    (``bound_full_output_ms``). ``bound_all_input_ms`` counts every row's
    words read, sentinel rows' too (the bound PRs 2-5 reported)."""
    bytes_in = P * cap * 4 + valid * width_in * 4
    bytes_out = n_out * (width + 1) * 4
    bytes_tail = (P * cap - n_out) * (width + 1) * 4
    bound = (bytes_in + bytes_out) / HBM_BYTES_PER_S * 1e3
    full = (bytes_in + bytes_out + bytes_tail) / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": bound, "bound_full_output_ms": full,
            "bound_all_input_ms": (P * cap * (width_in + 1) * 4
                                   + n_out * width * 4)
            / HBM_BYTES_PER_S * 1e3,
            "emit_share_of_bound": bound / times["emit_ms"],
            "share_of_full_bound": full / times["kernel_ms"],
            "bytes_in": bytes_in, "bytes_out": bytes_out,
            "bytes_tail": bytes_tail}


# -- merge-path kernel phase -------------------------------------------------
def _merge_keys(rng, n: int, pattern: str, side: str):
    """Keys and partitions of n rows of one side (any order)."""
    if pattern == "a_before_b":
        lo, hi = (0, SEG_R // 2) if side == "a" else (SEG_R // 2, SEG_R)
        return (rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64),
                rng.integers(lo, hi, n))
    if pattern == "ties":                  # few keys: equal rows both sides
        keys = rng.integers(-40, 40, n).astype(np.int64) * (1 << 33)
        return keys, (keys >> 33) % SEG_R
    if pattern == "sign_bits":
        return rng.choice(SIGN_KEYS, n), rng.integers(0, 3, n)
    return (rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64),
            rng.integers(0, SEG_R, n))


def _merge_side(rng, cap: int, width: int, keys, parts):
    """One shard's side of a merge: [cap, W] rows sorted by (partition,
    key) with [cap] partition ids, zero rows and the sentinel past the
    len(keys) valid rows."""
    n = len(keys)
    order = np.lexsort((keys, parts))
    rows = np.zeros((cap, width), np.int32)
    part = np.full(cap, SEG_R, np.int32)
    if n:
        rows[:n, :2] = keys[order].view(np.int32).reshape(n, 2)
        rows[:n, 2:] = rng.integers(-(1 << 31), 1 << 31, (n, width - 2))
        part[:n] = parts[order]
    return rows, part


def _merge_runs(rng, na: int, nb: int):
    """long_runs: keys and partitions of both sides, one sorted sequence
    cut into MERGE_RUNS taken by A and B in turn; partitions change at a
    few points inside runs."""
    total = sum(MERGE_RUNS)
    keys = np.sort(rng.integers(-(1 << 40), 1 << 40, total).astype(np.int64))
    parts = np.arange(total) * SEG_R // total
    side = np.repeat(np.arange(len(MERGE_RUNS)) % 2, MERGE_RUNS)
    return [(keys[idx], parts[idx]) for idx in
            (np.flatnonzero(side == 0)[:na], np.flatnonzero(side == 1)[:nb])]


def _on_card(x: np.ndarray, dev, off: int = 0):
    """x on the card as a contiguous view at storage offset ``off``."""
    import torch
    buf = torch.empty(x.size + off, dtype=torch.int32, device=dev)
    view = buf[off:].view(x.shape)
    view.copy_(torch.from_numpy(x))
    return view


def merge_kernel_phase(dev) -> int:
    import torch
    from sparkucx_tpu_torch.ops import segmented as sg
    rng = np.random.default_rng(SEED + 8)
    n = 0
    for width in MERGE_WIDTHS:
        for P in (1, 8):
            for pattern in MERGE_PATTERNS:
                ca, na, cb, nb = MERGE_SIZES[pattern]
                shards = []
                for p in range(P):
                    n_a, n_b = (max(0, v - 37 * p) if v else 0
                                for v in (na, nb))
                    kps = (_merge_runs(rng, n_a, n_b)
                           if pattern == "long_runs" else
                           [_merge_keys(rng, n_a, pattern, "a"),
                            _merge_keys(rng, n_b, pattern, "b")])
                    shards.append([_merge_side(rng, cap, width, *kp)
                                   for cap, kp in zip((ca, cb), kps)])
                offs = MERGE_OFFSET_WORDS if pattern == "offset" \
                    else (0,) * 4
                sides = [_on_card(np.stack([s[i // 2][i % 2]
                                            for s in shards]), dev, off)
                         for i, off in enumerate(offs)]
                out_cap = {"out_cap": (ca + cb) // 2 + 3,
                           "out_cap_mid": MERGE_OUT_CAP_MID}.get(pattern)
                kr, kp = sg.merge_kernel(*sides, out_cap)
                pr, pp = sg.merge_plain(*sides, out_cap)
                torch.cuda.synchronize()
                if not (torch.equal(kr, pr) and torch.equal(kp, pp)):
                    raise AssertionError(f"merge width={width} P={P} "
                                         f"{pattern}: kernel != plain")
                n += 1
    return n


# -- waved reads and the device merge fold -----------------------------------
def waved_read(svc, h, dev, **read_kw) -> tuple:
    """One measured waved read with the device sink: launch counts and
    peak memory reset just before; then its host view. Returns (parts,
    stats, report)."""
    import torch
    from sparkucx_tpu_torch import backend
    torch.cuda.reset_peak_memory_stats(dev)
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    res = svc.read(h, sink="device", **read_kw)
    torch.cuda.synchronize()
    read_ms = (time.perf_counter() - t0) * 1e3
    launches = backend.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    rep = svc.report(h.shuffle_id)
    d2h_before = rep.d2h_bytes
    t1 = time.perf_counter()
    hv = res.host_view()
    parts = [hv.partition(r) for r in range(PARTITIONS)]
    views_ms = (time.perf_counter() - t1) * 1e3
    # (a CPU view costs no copy, so only the card counts D2H bytes)
    if not (rep.waves == 5 and rep.sink == "device" and rep.merge_ms > 0
            and d2h_before == 0
            and (rep.d2h_bytes > 0 or dev.type != "cuda")):
        raise AssertionError(
            f"waved device read: waves={rep.waves} sink={rep.sink} "
            f"merge_ms={rep.merge_ms} d2h before/after host_view="
            f"{d2h_before}/{rep.d2h_bytes}")
    return parts, {"read_ms": read_ms, "views_ms": views_ms,
                   "merge_ms": rep.merge_ms, "pack_ms": rep.pack_ms,
                   "wave_pack_hidden_ms": rep.wave_pack_hidden_ms,
                   "wave_timeline": rep.wave_timeline,
                   "d2h_before_host_view": d2h_before,
                   "d2h_after_host_view": rep.d2h_bytes,
                   "peak_device_bytes": peak, "launches": launches,
                   "plan_bucket": rep.plan_bucket,
                   "wave_payload_rows": rep.wave_payload_rows}, rep


def host_waved_read(svc, h, **read_kw) -> tuple:
    """The same waved read with the host sink (the host cross-wave
    merge); the merge kernel must not run."""
    from sparkucx_tpu_torch import backend
    from sparkucx_tpu_torch.ops.segmented import MERGE_KERNEL_NAME
    backend.reset_launch_counts()
    parts, read_ms, views_ms = drive_read(svc, h, sink="host", **read_kw)
    rep = svc.report(h.shuffle_id)
    if rep.waves != 5 or rep.sink != "host" or \
            backend.launch_counts().get(MERGE_KERNEL_NAME, 0):
        raise AssertionError("host-sink waved read ran the device fold")
    return parts, {"read_ms": read_ms, "views_ms": views_ms,
                   "d2h_bytes": rep.d2h_bytes,
                   "wave_pack_hidden_ms": rep.wave_pack_hidden_ms,
                   "wave_timeline": rep.wave_timeline}


def profiled_device_read(svc, h, **read_kw) -> dict:
    """One more device-sink read under torch.profiler (the read alone,
    no host view): device busy time and idle share of its wall."""
    import torch
    with device_profile() as prof:
        t0 = time.perf_counter()
        res = svc.read(h, sink="device", **read_kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    res.close()
    return {"wall_ms": wall, **device_busy(prof, wall)}


def capture_last_merge(svc, h, name: str, **read_kw) -> dict:
    """One more device-sink read whose fold step calls of
    ``reader.<name>`` (``merge_rows`` for an ordered fold,
    ``merge_reduce_rows`` for a combine fold) are recorded: returns the
    arguments of the last one (the accumulator and the last wave, as the
    fold gave them)."""
    from sparkucx_tpu_torch.shuffle import reader as rd
    box, orig = {}, getattr(rd, name)

    def capture(*args, **kw):
        box["args"], box["kw"] = args, kw
        return orig(*args, **kw)

    setattr(rd, name, capture)
    try:
        svc.read(h, sink="device", **read_kw).close()
    finally:
        setattr(rd, name, orig)
    if "args" not in box:
        raise AssertionError(f"the device fold never called {name}")
    return box


def combine_fold_step_check(captured) -> dict:
    """The last fold step of waved_combine at its own shapes: the merge
    kernel bit-exact against merge_plain on the step's inputs, then the
    segment-reduce kernel exact against its plain version on the merged
    rows (int32 sums)."""
    import torch
    from sparkucx_tpu_torch.ops import segmented as sg
    a, ap, b, bp, num_parts, val_words, val_dtype = captured["args"][:7]
    if np.dtype(val_dtype) != np.int32:
        raise AssertionError(f"waved combine folds {val_dtype}, not int32")
    kw = captured["kw"]
    a, ap, b, bp = (t.contiguous() for t in (a, ap, b, bp))
    out_cap = kw["out_cap"]
    sw = kw.get("sum_words", 0) or val_words
    merge = merge_fold_step(a, ap, b, bp, out_cap, num_parts,
                            "combine fold")
    mr, mp = sg.merge_kernel(a, ap, b, bp, out_cap)
    kr, kp, kn = sg.segment_reduce_kernel(mr, mp, num_parts, sw, False)
    sr, sp, sn = sg.segment_reduce_plain(mr, mp, num_parts, sw, False)
    torch.cuda.synchronize()
    seg_err = int((kr.long() - sr.long()).abs().max())
    if seg_err or not (torch.equal(kp, sp) and torch.equal(kn, sn)):
        raise AssertionError(f"combine fold segment reduce: kernel != "
                             f"plain (err {seg_err})")
    return {"sum_words": sw, "merge": merge, "reduced_rows": int(kn.sum()),
            "merge_max_abs_err": merge["max_abs_err"],
            "segment_reduce_max_abs_err": seg_err}


def merge_fold_step(a, ap, b, bp, out_cap: int, num_parts: int,
                    what: str) -> dict:
    """One captured fold step's merge at its own shapes: the kernel
    bit-exact against merge_plain on every output row and partition id
    (the rows past the valid total included), its time (one call between
    CUDA events; 10 calls in a row; each pass's device time from
    torch.profiler) and the byte bound: out_cap rows of W + 1 words read
    and written per shard."""
    import torch
    from sparkucx_tpu_torch.ops import segmented as sg
    P, ca, W = a.shape

    def kernel():
        return sg.merge_kernel(a, ap, b, bp, out_cap)

    kr, kp = kernel()
    pr, pp = sg.merge_plain(a, ap, b, bp, out_cap)
    torch.cuda.synchronize()
    err = int((kr.long() - pr.long()).abs().max())
    if err or not torch.equal(kp, pp):
        raise AssertionError(f"{what} merge: kernel != plain (err {err})")
    valid = int((kp < num_parts).sum())
    del kr, kp, pr, pp
    bound = 2 * P * out_cap * (W + 1) * 4 / HBM_BYTES_PER_S * 1e3
    kernel_ms = median_ms(kernel)
    return {"a_shape": [P, ca, W], "b_shape": list(b.shape),
            "out_cap": out_cap, "a_valid_rows": int((ap < num_parts).sum()),
            "b_valid_rows": int((bp < num_parts).sum()),
            "valid_rows": valid, "max_abs_err": err, "kernel_ms": kernel_ms,
            "back_to_back_ms": back_to_back_ms(kernel),
            "device_ms": device_kernel_ms(kernel, MERGE_DEVICE_KERNELS),
            "host_ms": host_ms(kernel), "bound_ms": bound,
            "share_of_bound": bound / kernel_ms}


def check_sorted_oracle(parts, keys, values, pid, sink: str) -> None:
    allk = np.concatenate([parts[r][0] for r in range(PARTITIONS)])
    if allk.size != keys.size or (np.diff(allk) < 0).any():
        raise AssertionError(f"waved ordered ({sink}): not globally sorted")
    del allk
    check_against_oracle(parts, keys, values, PARTITIONS, pid=pid)


def waved_ordered_phase(dev, keys, values) -> tuple:
    from sparkucx_tpu_torch import connect
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME
    from sparkucx_tpu_torch.ops.segmented import MERGE_KERNEL_NAME
    bounds = terasort_bounds(keys)
    pid = np.searchsorted(bounds, keys, side="right").astype(np.int64)
    with connect(WAVE_CONF, num_shards=SHARDS, use_env=False) as svc:
        h = write_maps(svc, 20, keys, values, MAPS, "range", bounds)
        parts, stats, rep = waved_read(svc, h, dev, ordered=True)
        launches = stats["launches"]
        if launches.get(MERGE_KERNEL_NAME, 0) != 4 or \
                launches.get(KERNEL_NAME, 0):
            raise AssertionError(f"waved ordered launches {launches}")
        t = time.perf_counter()
        check_sorted_oracle(parts, keys, values, pid, "device")
        del parts
        hparts, hstats = host_waved_read(svc, h, ordered=True)
        check_sorted_oracle(hparts, keys, values, pid, "host")
        del hparts
        oracle_s = time.perf_counter() - t
        prof = profiled_device_read(svc, h, ordered=True)
        captured = capture_last_merge(svc, h, "merge_rows", ordered=True)
        svc.unregister_shuffle(20)
    return {"phase": "waved_ordered", "records": int(keys.size),
            "waves": rep.waves, "wave_rows": rep.wave_rows,
            "impl": rep.impl, "kernel": rep.kernel,
            "retries": rep.retries, "device": stats, "host": hstats,
            "oracle_s": oracle_s, "ok": True}, prof, captured


def merge_at_main_shapes(captured, dev) -> dict:
    """The last fold step of waved_ordered: kernel, plain version,
    merge_rows(impl="jnp") and the byte bound at its shapes."""
    import torch
    from sparkucx_tpu_torch.ops import segmented as sg
    a, ap, b, bp, num_parts = captured["args"]
    out_cap = captured["kw"]["out_cap"]
    P, ca, W = a.shape
    cb = b.shape[1]

    def kernel():
        return sg.merge_kernel(a, ap, b, bp, out_cap)

    def plain():
        return sg.merge_plain(a, ap, b, bp, out_cap)

    def library():
        return sg.merge_rows(a, ap, b, bp, num_parts, impl="jnp",
                             out_cap=out_cap)

    kr, kp = kernel()
    pr, pp = plain()
    lr, lp, _ = library()
    torch.cuda.synchronize()
    err = int((kr.long() - pr.long()).abs().max())
    if err or not torch.equal(kp, pp):
        raise AssertionError(f"merge disagrees at main shapes (err {err})")
    if not (torch.equal(kr[..., :2], lr[..., :2]) and torch.equal(kp, lp)):
        raise AssertionError("merge_rows(impl='jnp') disagrees on keys")
    valid = int((kp < num_parts).sum())
    del kr, kp, pr, pp, lr, lp
    # every output row comes from exactly one input row: the function
    # must read out_cap rows per shard and write as many
    row = (W + 1) * 4
    bytes_out = P * out_cap * row
    bytes_in = bytes_out
    both_in = P * (ca + cb) * row
    kernel_ms = median_ms(kernel)
    bound = (bytes_in + bytes_out) / HBM_BYTES_PER_S * 1e3
    return {
        "kernel_ms": kernel_ms, "share_of_bound": bound / kernel_ms,
        "back_to_back_ms": back_to_back_ms(kernel),
        "device_ms": device_kernel_ms(kernel, MERGE_DEVICE_KERNELS),
        "host_ms": host_ms(kernel),
        "plain_ms": median_ms(plain, reps=5, warmup=1),
        "library_ms": median_ms(library),
        "library_calls": "merge_rows(impl='jnp'): torch.sort of the keys, "
                         "a stable torch.sort of the partitions, row "
                         "gathers (no single PyTorch call merges)",
        "bound_ms": bound,
        # labelled alternatives: reading both buffers whole, and that
        # with all ca+cb rows written (no out_cap cut)
        "bound_reads_both_buffers_ms":
            (both_in + bytes_out) / HBM_BYTES_PER_S * 1e3,
        "bound_no_out_cap_cut_ms": 2 * both_in / HBM_BYTES_PER_S * 1e3,
        "max_abs_err": err, "a_shape": [P, ca, W], "b_shape": [P, cb, W],
        "out_cap": out_cap, "valid_rows": valid,
        "bytes_in": bytes_in, "bytes_out": bytes_out}


def waved_combine_phase(dev, keys, values) -> dict:
    from sparkucx_tpu_torch import connect
    from sparkucx_tpu_torch.ops.segmented import KERNEL_NAME as SEG
    from sparkucx_tpu_torch.ops.segmented import MERGE_KERNEL_NAME
    conf = dict(WAVE_CONF)
    conf["spark.shuffle.tpu.read.mergeImpl"] = "auto"
    uk, sums, _ = group_oracle(keys, values)
    want = (sums & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        h = write_maps(svc, 21, keys, values, MAPS)
        parts, stats, rep = waved_read(svc, h, dev, combine="sum")
        launches = stats["launches"]
        if launches.get(MERGE_KERNEL_NAME, 0) != 4 or \
                launches.get(SEG, 0) < 9:
            raise AssertionError(f"waved combine launches {launches}")
        t = time.perf_counter()
        gk, gv = combined_rows(parts, PARTITIONS,
                               lambda k: hash_pid(k, PARTITIONS))
        if not (np.array_equal(gk, uk) and np.array_equal(gv, want)):
            raise AssertionError("waved combine (device): sums differ")
        del parts
        hparts, hstats = host_waved_read(svc, h, combine="sum")
        gk, gv = combined_rows(hparts, PARTITIONS,
                               lambda k: hash_pid(k, PARTITIONS))
        if not (np.array_equal(gk, uk) and np.array_equal(gv, want)):
            raise AssertionError("waved combine (host): sums differ")
        oracle_s = time.perf_counter() - t
        captured = capture_last_merge(svc, h, "merge_reduce_rows",
                                      combine="sum")
        svc.unregister_shuffle(21)
    # waved_combine_lossless: the host-sink read again with the drained
    # waves held compressed; its partitions must equal the raw read's bit
    # for bit
    conf["spark.shuffle.tpu.a2a.wire"] = "lossless"
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        h = write_maps(svc, 22, keys, values, MAPS)
        lparts, lstats = host_waved_read(svc, h, combine="sum")
        lrep = svc.report(22)
        svc.unregister_shuffle(22)
    for r in range(PARTITIONS):
        if not (np.array_equal(lparts[r][0], hparts[r][0])
                and np.array_equal(lparts[r][1], hparts[r][1])):
            raise AssertionError(f"waved combine (lossless): partition {r} "
                                 f"differs from the raw read")
    if lrep.wire != "lossless" or lrep.lossless_bytes <= 0:
        raise AssertionError(f"lossless read: wire {lrep.wire}, "
                             f"lossless_bytes {lrep.lossless_bytes}")
    del hparts, lparts
    lossless = {"phase": "waved_combine_lossless", **lstats,
                "lossless_bytes": lrep.lossless_bytes,
                "payload_bytes": lrep.payload_bytes,
                "raw_host_read_ms": hstats["read_ms"], "ok": True}
    if rep.kernel != "pallas":
        raise AssertionError(f"waved combine ran kernel tier {rep.kernel}")
    fold = combine_fold_step_check(captured)
    del captured
    return {"phase": "waved_combine", "records": int(keys.size),
            "waves": rep.waves, "kernel": rep.kernel, "rows_out": int(uk.size),
            "retries": rep.retries, "device": stats, "host": hstats,
            "fold_step_check": fold, "oracle_s": oracle_s,
            "ok": True}, lossless


# -- int8 wire: the quantize and fused dequant-reduce kernels ----------------
def quant_values(rng, n: int, w: int, kind: str) -> np.ndarray:
    """[n, w] float32: normal; with zero rows; rows at their own scale
    from 1e-30 to 1e30; or lanes near the float32 maximum (x / scale
    lands on 127)."""
    x = rng.standard_normal((n, w)).astype(np.float32)
    if kind == "magnitudes":
        x = (x * 10.0 ** rng.uniform(-30, 30, (n, 1))).astype(np.float32)
        x[::5] *= (10.0 ** rng.uniform(-4, 4, (1, w))).astype(np.float32)
    if kind in ("zero_rows", "magnitudes"):
        x[::7] = 0.0
        x[3::11, 0] = -0.0
    if kind == "saturate":
        x[:, 0] = np.float32(3.4e38) * np.sign(x[:, 0] + 1e-9)
        x[:, -1] = np.nextafter(x[:, 0], np.float32(0))
    return x


def quant_kernel_phase(dev) -> int:
    """The quantize kernel against its plain version on the same
    uniforms: q and scale byte for byte."""
    import torch
    from sparkucx_tpu_torch.ops import quant as tq
    rng = np.random.default_rng(SEED + 9)
    n_cases = 0
    for n in (1, 389, 4099, 16411):
        for w in (1, 3, 4, 128, 1000):
            for kind in QUANT_KINDS:
                x = torch.from_numpy(quant_values(rng, n, w, kind)).to(dev)
                u = torch.from_numpy(rng.random((n, w), dtype=np.float32)) \
                    .to(dev)
                kq, ks = tq.quantize_kernel(x, u)
                pq, ps = tq.quantize_plain(x, u)
                torch.cuda.synchronize()
                if not (torch.equal(kq, pq) and torch.equal(
                        ks.view(torch.int32), ps.view(torch.int32))):
                    raise AssertionError(f"quantize n={n} w={w} {kind}: "
                                         f"kernel bytes != plain")
                n_cases += 1
    return n_cases


def wire_rows_case(rng, cap: int, ww: int, pattern: str, sum_words: int):
    """One shard of int8 wire rows [cap, 2 + ceil(ww/4) + 1] sorted by
    (partition, key), [cap] partitions (sentinel SEG_R past the valid
    rows) and the [cap, ww] float32 values they decode to; carried
    lanes' bytes are a constant of the key, scales vary per row."""
    qw = -(-ww // 4)
    rows = np.zeros((cap, 2 + qw + 1), np.int32)
    part = np.full(cap, SEG_R, np.int32)
    vals = np.zeros((cap, ww), np.float32)
    if pattern == "empty":
        return rows, part, vals
    n = cap - cap // 7 if pattern == "unique" else cap
    if pattern == "unique":
        keys = rng.choice(1 << 40, n, replace=False).astype(np.int64)
    elif pattern == "one_key":
        keys = np.full(n, -(1 << 35) - 3, np.int64)
    else:
        keys = np.repeat(rng.integers(-(1 << 40), 1 << 40, n),
                         rng.integers(1, 600, n))[:n]
    if pattern == "sentinel":
        rows[:, :2] = rng.integers(-9, 9, (cap, 2))
        return rows, part, vals
    p = (keys % SEG_R).astype(np.int32)
    order = np.lexsort((keys, p))
    keys, p = keys[order], p[order]
    q = rng.integers(-127, 128, (n, ww)).astype(np.int8)
    sw = sum_words or ww
    q[:, sw:] = ((keys * 7 + 3)[:, None] % 255 - 127).astype(np.int8)
    scale = np.exp(rng.normal(0, 3, n)).astype(np.float32)
    qb = np.zeros((n, 4 * qw), np.int8)
    qb[:, :ww] = q
    rows[:n, :2] = keys.view(np.int32).reshape(n, 2)
    rows[:n, 2:2 + qw] = qb.view(np.int32)
    rows[:n, 2 + qw] = scale.view(np.int32)
    part[:n] = p
    vals[:n] = q.astype(np.float32) * scale[:, None]
    return rows, part, vals


def wire_run_tolerance(vals, part, rows, sum_words: int) -> np.ndarray:
    """run_tolerance over decoded values: n * 2**-24 * sum|v| per run."""
    full = np.zeros(part.shape + (2 + vals.shape[2],), np.int32)
    full[..., :2] = rows[..., :2]
    full[..., 2:] = vals.view(np.int32)
    return run_tolerance(full, part, sum_words)


def wire_reduce_kernel_phase(dev) -> dict:
    """The fused dequant segment reduce against its plain version: keys,
    partitions, n_out and carried lanes exact; float32 sums within the
    sequential-summation bound of each run."""
    import torch
    from sparkucx_tpu_torch.ops import segmented as sg
    rng = np.random.default_rng(SEED + 10)
    n, f32_err = 0, 0.0
    for ww in (1, 4, 7, 128):
        for P in (1, 8):
            cap = 1500 if P == 8 else 5000
            for i, pattern in enumerate(SEG_PATTERNS):
                pats = [SEG_PATTERNS[(i + s) % len(SEG_PATTERNS)]
                        for s in range(P)]
                for sw in sorted({ww, max(1, ww // 2)}):
                    shards = [wire_rows_case(rng, cap, ww, q, sw)
                              for q in pats]
                    rows_np = np.stack([x[0] for x in shards])
                    part_np = np.stack([x[1] for x in shards])
                    vals_np = np.stack([x[2] for x in shards])
                    rows = torch.from_numpy(rows_np).to(dev)
                    part = torch.from_numpy(part_np).to(dev)
                    width = 2 + ww
                    kr, kp, kn = sg.segment_reduce_wire_kernel(
                        rows, part, SEG_R, width, ww, sw)
                    pr, pp, pn = sg.segment_reduce_wire_plain(
                        rows, part, SEG_R, width, ww, sw)
                    torch.cuda.synchronize()
                    tag = f"wire ww={ww} P={P} {pattern} sum_words={sw}"
                    if not (torch.equal(kn, pn) and torch.equal(kp, pp)):
                        raise AssertionError(f"{tag}: n_out/part differ")
                    exact = [0, 1] + list(range(2 + sw, width))
                    if not torch.equal(kr[..., exact], pr[..., exact]):
                        raise AssertionError(f"{tag}: keys/carry differ")
                    got = kr[..., 2:2 + sw].contiguous().view(
                        torch.float32).double().cpu().numpy()
                    want = pr[..., 2:2 + sw].contiguous().view(
                        torch.float32).double().cpu().numpy()
                    diff = np.abs(got - want)
                    if (diff > wire_run_tolerance(vals_np, part_np, rows_np,
                                                  sw)).any():
                        raise AssertionError(f"{tag}: sums outside bound")
                    f32_err = max(f32_err, float(diff.max()))
                    n += 1
    return {"cases": n, "f32_max_abs_err": f32_err}


# -- int8 reads: a DLRM-style embedding-gradient shuffle ---------------------
def make_embedding_grads(n: int, seed: int):
    """(embedding row ids int64 [n], Zipf(1.05) over EMB_IDS ids, spread
    over the id space by a multiplicative hash; gradient rows float32
    [n, EMB_DIM])."""
    rng = np.random.default_rng(seed)
    cdf = np.cumsum(np.arange(1, EMB_IDS + 1, dtype=np.float64) ** -1.05)
    cdf /= cdf[-1]
    rank = np.searchsorted(cdf, rng.random(n))
    del cdf
    ids = (rank.astype(np.int64) * 2654435761) % EMB_IDS
    grads = rng.standard_normal((n, EMB_DIM), dtype=np.float32)
    return ids, grads


def staged_groups(n: int, wave_rows: int = 0) -> np.ndarray:
    """For each record (written by write_maps over MAPS maps): its shard
    (map % SHARDS), or with ``wave_rows`` its (wave, shard) as one id —
    the groups a map-side combine sums separately."""
    per = -(-n // MAPS)
    i = np.arange(n, dtype=np.int64)
    m = i // per
    shard = m % SHARDS
    if not wave_rows:
        return shard
    pos = (m // SHARDS) * per + (i - m * per)
    return (pos // wave_rows) * SHARDS + shard


def check_int8_combine(parts, keys, values, groups, tag: str, dev) -> dict:
    """Keys unique, sorted and in their partition; every sum within one
    quantization step of every map-side partial row it adds (each (key,
    group) sum, ``groups`` from :func:`staged_groups`) plus 2**-20 of
    each partial, for its float32 rounding and the float32 sums after the
    exchange; and the mean signed error within 5 standard errors of 0
    (stochastic rounding is unbiased). The float64 oracle sums run as
    plain ``index_add_`` calls on the card."""
    import torch
    order = np.lexsort((groups, keys))
    sk, sgr = keys[order], groups[order]
    gnew = np.r_[True, (sk[1:] != sk[:-1]) | (sgr[1:] != sgr[:-1])]
    rec_group = np.empty(keys.size, np.int64)
    rec_group[order] = np.cumsum(gnew) - 1
    gkeys = sk[gnew]
    del order, sk, sgr
    knew = np.r_[True, gkeys[1:] != gkeys[:-1]]
    group_key = np.cumsum(knew) - 1
    uk = gkeys[knew]
    W = values.shape[1]
    partial = torch.zeros((gkeys.size, W), dtype=torch.float64, device=dev)
    partial.index_add_(0, torch.from_numpy(rec_group).to(dev),
                       torch.from_numpy(values).to(dev).double())
    gk_dev = torch.from_numpy(group_key).to(dev)
    total = torch.zeros((uk.size, W), dtype=torch.float64, device=dev)
    total.index_add_(0, gk_dev, partial)
    step = partial.abs().amax(dim=1, keepdim=True) / 127.0 * (1 + 1e-5)
    tol = torch.zeros_like(total)
    tol.index_add_(0, gk_dev, step + 2.0 ** -20 * partial.abs())
    del partial, step
    gk, gv = combined_rows(parts, PARTITIONS,
                           lambda k: hash_pid(k, PARTITIONS))
    if not np.array_equal(gk, uk):
        raise AssertionError(f"{tag}: keys differ from the oracle")
    err = torch.from_numpy(gv).to(dev).double() - total
    ratio = float((err.abs() / tol).max())
    if ratio > 1:
        raise AssertionError(f"{tag}: sums outside one quantization step "
                             f"(worst {ratio} x tol)")
    z = float(err.mean() / (err.std() / err.numel() ** 0.5))
    if abs(z) > 5:
        raise AssertionError(f"{tag}: biased rounding, mean error is {z} "
                             f"standard errors from 0")
    return {"rows_out": int(uk.size),
            "max_abs_err": float(err.abs().max()),
            "max_err_over_tol": ratio, "mean_err_z": z}


def check_raw_multiset(parts, keys, values) -> None:
    """Raw read: every partition holds exactly its (key, row) multiset."""
    pid = hash_pid(keys, PARTITIONS)
    vb = values.view(np.int32)
    order = np.lexsort((vb[:, 1], vb[:, 0], keys, pid))
    bounds = np.r_[0, np.cumsum(np.bincount(pid, minlength=PARTITIONS))]
    for r in range(PARTITIONS):
        gk, gv = parts[r]
        want = order[bounds[r]:bounds[r + 1]]
        if gk.shape[0] != want.size:
            raise AssertionError(f"raw partition {r}: {gk.shape[0]} rows, "
                                 f"oracle {want.size}")
        gb = gv.view(np.int32)
        o = np.lexsort((gb[:, 1], gb[:, 0], gk))
        if not (np.array_equal(gk[o], keys[want])
                and np.array_equal(gb[o], vb[want])):
            raise AssertionError(f"raw partition {r}: rows differ")


def check_int8_plain(parts, raw_parts) -> dict:
    """int8 against the raw read of the same staging: the same keys in the
    same places (the send sort orders rows by partition alone, stably),
    every value within one quantization step of its raw row."""
    worst = 0.0
    for r in range(PARTITIONS):
        gk, gv = parts[r]
        rk, rv = raw_parts[r]
        if not np.array_equal(gk, rk):
            raise AssertionError(f"int8 partition {r}: keys or row order "
                                 f"differ from the raw read")
        step = np.abs(rv).max(axis=1, keepdims=True) / 127.0
        err = np.abs(gv.astype(np.float64) - rv)
        if (err > step * (1 + 1e-6)).any():
            raise AssertionError(f"int8 partition {r}: a value is more "
                                 f"than one quantization step off")
        worst = max(worst, float((err / np.maximum(step, 1e-30)).max()))
    return {"max_err_in_steps": worst}


def int8_read(svc, h, dev, kernels, **read_kw):
    """One measured read with the kernel counts reset just before; every
    kernel of ``kernels`` must have launched."""
    import torch
    from sparkucx_tpu_torch import backend
    torch.cuda.reset_peak_memory_stats(dev)
    backend.reset_launch_counts()
    parts, read_ms, views_ms = drive_read(svc, h, **read_kw)
    launches = {k: counted(k) for k in kernels}
    rep = svc.report(h.shuffle_id)
    return parts, {"read_ms": read_ms, "views_ms": views_ms,
                   "pack_ms": rep.pack_ms, "dispatch_ms": rep.dispatch_ms,
                   "group_ms": rep.group_ms, "wire": rep.wire,
                   "payload_bytes": rep.payload_bytes,
                   "wire_bytes": rep.wire_bytes, "pad_ratio": rep.pad_ratio,
                   "wire_dequant_error": rep.wire_dequant_error,
                   "retries": rep.retries, "plan_bucket": rep.plan_bucket,
                   "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
                   "launches": launches,
                   "all_launches": backend.launch_counts()}, rep


def expect_launches(tag: str, stats: dict, want: dict) -> None:
    got = {k: stats["all_launches"].get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, expected {want}")


def capture_calls(targets, fn):
    """Run ``fn()`` with each (module, name) of ``targets`` wrapped to
    record the arguments of its last call; returns {name: (args, kw)}."""
    box, saved = {}, []
    for mod, name in targets:
        orig = getattr(mod, name)
        saved.append((mod, name, orig))

        def capture(*args, _name=name, _orig=orig, **kw):
            box[_name] = (args, kw)
            return _orig(*args, **kw)

        setattr(mod, name, capture)
    try:
        fn()
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    missing = [n for _, n in targets if n not in box]
    if missing:
        raise AssertionError(f"the read never called {missing}")
    return box


def int8_phases(dev) -> tuple:
    """int8_plain, int8_combine and waved_int8_combine over one DLRM-style
    gradient shuffle, each beside the same read on the raw wire."""
    from sparkucx_tpu_torch import connect
    from sparkucx_tpu_torch.ops import quant as tq
    from sparkucx_tpu_torch.ops import segmented as sg
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME as A2A
    from sparkucx_tpu_torch.shuffle import alltoall as at
    from sparkucx_tpu_torch.shuffle import reader as rd
    t = time.perf_counter()
    keys, grads = make_embedding_grads(INT8_RECORDS, SEED + 11)
    wk, wg = make_embedding_grads(1 << 14, SEED + 12)
    gen_s = time.perf_counter() - t
    out = {}

    # -- int8_plain: the un-combined gradient all-to-all -----------------
    def plain(wire: str, kernels):
        conf = {"spark.shuffle.tpu.a2a.impl": "pallas",
                "spark.shuffle.tpu.a2a.wire": wire}
        with connect(conf, num_shards=SHARDS, use_env=False) as svc:
            warm_read(svc, 30, wk, wg)
            h = write_maps(svc, 31, keys, grads, MAPS)
            parts, stats, rep = int8_read(svc, h, dev, kernels)
            svc.unregister_shuffle(31)
        return parts, stats, rep

    raw_parts, raw_stats, _ = plain("raw", (A2A,))
    check_raw_multiset(raw_parts, keys, grads)
    parts, stats, rep = plain("int8", (tq.KERNEL_NAME, A2A))
    expect_launches("int8_plain", stats, {tq.KERNEL_NAME: 1 + rep.retries,
                                          A2A: 1 + rep.retries})
    if rep.wire != "int8":
        raise AssertionError(f"int8_plain ran the {rep.wire} wire")
    t = time.perf_counter()
    chk = check_int8_plain(parts, raw_parts)
    del parts, raw_parts
    out["int8_plain"] = {"phase": "int8_plain", "records": INT8_RECORDS,
                         "value_lanes": EMB_DIM, "int8": stats,
                         "raw": raw_stats, **chk,
                         "oracle_s": time.perf_counter() - t, "ok": True}

    # -- int8_combine: the same gradients summed per embedding row ---------
    groups = staged_groups(INT8_RECORDS)

    def combine(wire: str, kernels, capture: bool = False):
        conf = {"spark.shuffle.tpu.a2a.impl": "pallas",
                "spark.shuffle.tpu.a2a.wire": wire,
                "spark.shuffle.tpu.read.mergeImpl": "auto"}
        box = None
        with connect(conf, num_shards=SHARDS, use_env=False) as svc:
            warm_read(svc, 32, wk, wg, combine="sum")
            h = write_maps(svc, 33, keys, grads, MAPS)
            parts, stats, rep = int8_read(svc, h, dev, kernels,
                                          combine="sum")
            if capture:
                # one more read whose quantize and fused-reduce inputs are
                # kept for the kernels' timing at these shapes
                box = capture_calls(
                    [(at, "quantize_rows"), (rd, "segment_reduce_wire_rows")],
                    lambda: svc.read(h, combine="sum"))
            svc.unregister_shuffle(33)
        return parts, stats, rep, box

    rparts, raw_cstats, _, _ = combine("raw", (A2A, sg.KERNEL_NAME))
    del rparts
    parts, cstats, crep, box = combine(
        "int8", (tq.KERNEL_NAME, A2A, sg.WIRE_KERNEL_NAME), capture=True)
    expect_launches("int8_combine", cstats, {
        tq.KERNEL_NAME: 1 + crep.retries, A2A: 1 + crep.retries,
        sg.WIRE_KERNEL_NAME: 1 + crep.retries, sg.KERNEL_NAME: 0})
    if crep.kernel != "pallas" or crep.wire != "int8":
        raise AssertionError(f"int8_combine ran {crep.wire}/{crep.kernel}")
    t = time.perf_counter()
    cchk = check_int8_combine(parts, keys, grads, groups, "int8_combine",
                              dev)
    part_rows = [int(parts[r][0].shape[0]) for r in range(PARTITIONS)]
    del parts
    out["int8_combine"] = {"phase": "int8_combine", "int8": cstats,
                           "raw": raw_cstats, **cchk,
                           "oracle_s": time.perf_counter() - t, "ok": True}

    # -- waved_int8_combine: the combine as a streaming device-sink read ---
    wgroups = staged_groups(INT8_RECORDS, INT8_WAVE_ROWS)

    def waved(wire: str, capture: bool = False):
        conf = {"spark.shuffle.tpu.a2a.impl": "dense",
                "spark.shuffle.tpu.a2a.wire": wire,
                "spark.shuffle.tpu.a2a.waveRows": str(INT8_WAVE_ROWS),
                "spark.shuffle.tpu.a2a.waveDepth": "2",
                "spark.shuffle.tpu.read.mergeImpl": "auto"}
        box = None
        with connect(conf, num_shards=SHARDS, use_env=False) as svc:
            h = write_maps(svc, 34, keys, grads, MAPS)
            parts, stats, rep = waved_read(svc, h, dev, combine="sum")
            if capture:
                # one more read whose last fold step is kept: the merge
                # of full-width rows (2 key words + EMB_DIM float32 lanes)
                box = capture_last_merge(svc, h, "merge_reduce_rows",
                                         combine="sum")
            svc.unregister_shuffle(34)
        return parts, stats, rep, box

    rparts, raw_wstats, raw_wrep, _ = waved("raw")
    del rparts
    parts, wstats, wrep, fold_box = waved("int8", capture=True)
    want = {tq.KERNEL_NAME: 5, sg.WIRE_KERNEL_NAME: 5,
            sg.MERGE_KERNEL_NAME: 4, sg.KERNEL_NAME: 4}
    got = {k: wstats["launches"].get(k, 0) for k in want}
    if got != want or wrep.wire != "int8":
        raise AssertionError(f"waved_int8_combine launches {got}, "
                             f"expected {want} (wire {wrep.wire})")
    t = time.perf_counter()
    wchk = check_int8_combine(parts, keys, grads, wgroups,
                              "waved_int8_combine", dev)
    del parts
    for st, r in ((wstats, wrep), (raw_wstats, raw_wrep)):
        st.update({"wire_bytes": r.wire_bytes, "pad_ratio": r.pad_ratio,
                   "wire_dequant_error": r.wire_dequant_error})
    oracle_s = time.perf_counter() - t
    a, ap, b, bp, num_parts = fold_box["args"][:5]
    if a.shape[2] != 2 + EMB_DIM:
        raise AssertionError(f"int8 fold merges rows of {a.shape[2]} words")
    fold = merge_fold_step(a, ap, b, bp, fold_box["kw"]["out_cap"],
                           num_parts, "int8 combine fold")
    del a, ap, b, bp, fold_box
    out["waved_int8_combine"] = {
        "phase": "waved_int8_combine", "waves": wrep.waves,
        "wave_rows": INT8_WAVE_ROWS, "int8": wstats, "raw": raw_wstats,
        **wchk, "fold_step_check": fold, "oracle_s": oracle_s, "ok": True}
    out["gen_s"] = gen_s
    return out, box, part_rows, cstats


def quant_at_main_shapes(box) -> dict:
    """The quantize call of int8_combine's send buffer, with its own
    uniforms: kernel == plain byte for byte, both timed beside the byte
    bound."""
    import torch
    from sparkucx_tpu_torch.ops import quant as tq
    (x, u), _ = box["quantize_rows"]
    x, u = x.contiguous(), u.contiguous()
    kq, ks = tq.quantize_kernel(x, u)
    pq, ps = tq.quantize_plain(x, u)
    torch.cuda.synchronize()
    diff = int((kq.int() - pq.int()).abs().max())
    if diff or not torch.equal(ks.view(torch.int32), ps.view(torch.int32)):
        raise AssertionError(f"quantize disagrees at main shapes "
                             f"(q err {diff})")
    del kq, ks, pq, ps
    n, w = x.shape
    moved = 4 * n * w + 4 * n * w + n * w + 4 * n
    return {
        "kernel_ms": median_ms(lambda: tq.quantize_kernel(x, u)),
        "plain_ms": median_ms(lambda: tq.quantize_plain(x, u), reps=5,
                              warmup=1),
        "library_ms": None,
        "library_note": "no single PyTorch call computes per-row "
                        "stochastic int8 rounding",
        "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bytes": moved,
        "max_abs_err": diff, "shape": [n, w]}


def wire_reduce_at_main_shapes(box, part_rows, dev) -> dict:
    """The fused reduce of int8_combine at its own input (the keysorted
    wire rows the read handed it): kernel against plain (keys, partitions
    and n_out exact; sums within n * 2**-24 * sum|v| per run), one
    index_add_ of the dequantized sum lanes into precomputed run slots
    as the library yardstick, and the byte bound."""
    import torch
    from sparkucx_tpu_torch.ops import segmented as sg
    from sparkucx_tpu_torch.ops.partition import (counts_from_sorted,
                                                  words_to_key)
    from sparkucx_tpu_torch.shuffle.alltoall import wire_unpack_rows
    (rows, part, num_parts, width, ww), kw = box["segment_reduce_wire_rows"]
    sw = kw.get("sum_words", 0) or ww
    rows, part = rows.contiguous(), part.to(torch.int32).contiguous()
    P, cap, w_in = rows.shape

    def kernel():
        return sg.segment_reduce_wire_kernel(rows, part, num_parts, width,
                                             ww, sw)

    def plain():
        return sg.segment_reduce_wire_plain(rows, part, num_parts, width,
                                            ww, sw)

    kr, kp, kn = kernel()
    pr, pp, pn = plain()
    again = kernel()
    torch.cuda.synchronize()
    if not (torch.equal(kn, pn) and torch.equal(kp, pp)
            and torch.equal(kr[..., :2], pr[..., :2])
            and torch.equal(kr[..., 2 + sw:], pr[..., 2 + sw:])):
        raise AssertionError("fused reduce: keys, partitions, n_out or "
                             "carried lanes differ at main shapes")
    if not all(torch.equal(a, b) for a, b in zip(again, (kr, kp, kn))):
        raise AssertionError("two launches of the fused reduce differ")
    del again
    if counts_from_sorted(kp, num_parts).sum(dim=0).cpu().tolist() \
            != part_rows:
        raise AssertionError("captured input is not the int8 combine's")
    # run ids of the sorted input, the run tolerance and the yardstick's
    # inputs, all outside the timed calls
    valid = part < num_parts
    key = words_to_key(rows[..., 0], rows[..., 1])
    same = torch.zeros_like(valid)
    same[:, 1:] = (key[:, 1:] == key[:, :-1]) & (part[:, 1:] == part[:, :-1])
    run = torch.cumsum(valid & ~same, dim=1) - 1
    dest = (run + torch.arange(P, device=dev)[:, None] * cap)[valid]
    del key, same, run
    lanes = wire_unpack_rows(rows, width, ww)[..., 2:2 + sw][valid] \
        .contiguous().view(torch.float32)
    nrun = torch.zeros(P * cap, dtype=torch.float64, device=dev)
    nrun.index_add_(0, dest, torch.ones_like(dest, dtype=torch.float64))
    sabs = torch.zeros((P * cap, sw), dtype=torch.float64, device=dev)
    sabs.index_add_(0, dest, lanes.abs().double())
    tol = (nrun[:, None] * 2.0 ** -24 * sabs).reshape(P, cap, sw)
    del nrun, sabs
    got = kr[..., 2:2 + sw].contiguous().view(torch.float32).double()
    want = pr[..., 2:2 + sw].contiguous().view(torch.float32).double()
    diff = (got - want).abs()
    if bool((diff > tol).any()):
        raise AssertionError("fused reduce: sums outside the sequential "
                             "summation bound at main shapes")
    err = float(diff.max())
    n_out = int(kn.sum())
    nvalid = int(valid.sum())
    del pr, pp, got, want, diff, tol, valid
    acc = torch.zeros((P * cap, sw), dtype=torch.float32, device=dev)

    def library():
        return acc.index_add_(0, dest, lanes)

    times = reduce_times(kernel, plain, library, kr, kp, kn, num_parts)
    return {**times, **reduce_bounds(P, cap, w_in, width, nvalid, n_out,
                                     times),
            "library_calls": "index_add_ of the dequantized sum lanes of "
                             "the valid rows into precomputed run slots",
            "max_abs_err": err, "input_shape": [P, cap, w_in],
            "valid_rows": nvalid, "n_out": n_out}


def default_conf_phase(dev) -> dict:
    """Under the default conf (``a2a.impl=auto``) a waved device-sink
    read keeps its waves on the dense exchange; under an explicit
    ``a2a.impl=pallas`` a plain device-sink read hands each shard's
    delivered rows over as the prefix ``device_totals`` gives, which
    decodes exactly to the rows written for that shard's partitions."""
    import torch
    from sparkucx_tpu_torch import backend, connect
    from sparkucx_tpu_torch.ops.partition import blocked_partition_map
    keys, values = make_records(DEFAULT_RECORDS, zipf=False, seed=SEED + 9)
    out = {"phase": "default_conf", "records": DEFAULT_RECORDS}
    with connect({"spark.shuffle.tpu.a2a.waveRows":
                  str(DEFAULT_WAVE_ROWS)}, num_shards=SHARDS,
                 use_env=False) as svc:
        h = write_maps(svc, 40, keys, values, MAPS)
        backend.reset_launch_counts()
        t0 = time.perf_counter()
        res = svc.read(h, sink="device")
        torch.cuda.synchronize()
        read_ms = (time.perf_counter() - t0) * 1e3
        rep = svc.report(40)
        launches = backend.launch_counts()
        if not (rep.waves > 1 and rep.impl == "dense" and rep.d2h_bytes == 0
                and res.waves == rep.waves):
            raise AssertionError(f"default-conf waved read: waves="
                                 f"{rep.waves} impl={rep.impl}")
        hv = res.host_view()
        check_against_oracle([hv.partition(r) for r in range(PARTITIONS)],
                             keys, values, PARTITIONS)
        out["waved_device"] = {"waves": rep.waves, "impl": rep.impl,
                               "read_ms": read_ms, "launches": launches,
                               "integrity": rep.integrity,
                               "integrity_bytes": rep.integrity_bytes}
    with connect({"spark.shuffle.tpu.a2a.impl": "pallas"},
                 num_shards=SHARDS, use_env=False) as svc:
        h = write_maps(svc, 41, keys, values, MAPS)
        backend.reset_launch_counts()
        t0 = time.perf_counter()
        res = svc.read(h, sink="device")
        torch.cuda.synchronize()
        read_ms = (time.perf_counter() - t0) * 1e3
        launches = {KERNEL_A2A: counted(KERNEL_A2A)}
        rep = svc.report(41)
        if rep.impl != "pallas" or rep.d2h_bytes != 0:
            raise AssertionError(f"explicit pallas device read: impl="
                                 f"{rep.impl} d2h={rep.d2h_bytes}")
        rows = res.device_rows().cpu().numpy()
        totals = res.device_totals().cpu().numpy()
        res.close()
    shard_of = blocked_partition_map(PARTITIONS, SHARDS)[
        hash_pid(keys, PARTITIONS)]
    for p in range(SHARDS):
        got = rows[p, :totals[p]]
        gk = got[:, :2].copy().view(np.int64)[:, 0]
        sel = np.flatnonzero(shard_of == p)
        o = np.lexsort((got[:, 2], gk))
        want = sel[np.lexsort((values[sel, 0], keys[sel]))]
        if not (np.array_equal(gk[o], keys[want])
                and np.array_equal(got[o, 2:], values[want])):
            raise AssertionError(f"shard {p}: the device_totals prefix is "
                                 f"not the rows written for it")
    out["pallas_device"] = {"impl": rep.impl, "read_ms": read_ms,
                            "launches": launches,
                            "integrity": rep.integrity,
                            "integrity_bytes": rep.integrity_bytes,
                            "totals": [int(x) for x in totals]}
    return {**out, "ok": True}



# -- attention: Ulysses and ring on the device sink, the flash kernels ------
def attention_constants() -> dict:
    return {"heads": ATTN_HEADS, "head_dim": ATTN_HEAD_DIM,
            "tokens": ATTN_TOKENS, "shards": SHARDS}


def flash_close(got, want, tol, what: str) -> float:
    """Max |got - want|; raises where it exceeds ``tol`` (a number or a
    tensor broadcast against the difference)."""
    err = (got - want).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"{what}: max error {float(err.max())} beyond "
                             f"its tolerance")
    return float(err.max()) if err.numel() else 0.0


def out_tol(want) -> float:
    """O: 1e-4 of the largest |O| plus 1e-6."""
    return 1e-4 * float(want.abs().max()) + 1e-6 if want.numel() else 1e-6


def grad_tol(want, plain_err: float = 0.0) -> float:
    """dq, dk, dv: 1e-3 of the largest |grad| plus the larger of 1e-5 and
    four times ``plain_err``, the plain version's own distance from a
    float64 reference on the same inputs (where a gradient vanishes,
    both float32 versions hold only the rounding of dP - delta: 2e-6 to
    5e-6 from float64 at D = 128)."""
    big = float(want.abs().max()) if want.numel() else 0.0
    return 1e-3 * big + max(1e-5, 4.0 * plain_err)


def float64_grads(q, k, v, g, causal: bool, scale: float):
    """O and (dq, dk, dv) of [BH, T, D] attention in float64, by autograd
    through reference_attention: the truth the plain versions are
    measured against."""
    import torch
    from sparkucx_tpu_torch.ops.attention import reference_attention
    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    o = reference_attention(*(x[None] for x in leaves), causal=causal,
                            scale=scale)[0]
    return o.detach(), torch.autograd.grad(o, leaves, g.double())


def flash_kernels_phase(dev) -> dict:
    """Each flash kernel against its plain version on the card: T in
    FLASH_T x D in FLASH_D x causal / not x BH in {1, 6}; the backward
    kernels on the plain forward's lse and delta. Tolerances: O within
    1e-4 max|O| + 1e-6, lse within 1e-5 (1 + |lse|), grads within
    :func:`grad_tol` of the plain version's, with the plain version's own
    distance from float64 measured per case."""
    import torch
    from sparkucx_tpu_torch.ops import flash_attention as tfa
    n = 0
    worst = {"fwd": 0.0, "lse": 0.0, "dq": 0.0, "dkv": 0.0,
             "plain_vs_float64": 0.0}
    for bh in (1, 6):
        for causal in (False, True):
            for d in FLASH_D:
                for t in FLASH_T:
                    gen = torch.Generator(device=dev).manual_seed(
                        SEED + bh * 100_003 + t * 1009 + d * 7 + causal)
                    q, k, v, g = (torch.randn((bh, t, d), generator=gen,
                                              device=dev) for _ in range(4))
                    scale = d ** -0.5
                    ko, klse = tfa.flash_fwd_kernel(q, k, v, causal, scale)
                    po, plse = tfa.flash_fwd_plain(q, k, v, causal, scale)
                    delta = (g * po).sum(dim=-1)
                    kdq = tfa.flash_dq_kernel(q, k, v, g, plse, delta,
                                              causal, scale)
                    kdk, kdv = tfa.flash_dkv_kernel(q, k, v, g, plse, delta,
                                                    causal, scale)
                    torch.cuda.synchronize()
                    pdq = tfa.flash_dq_plain(q, k, v, g, plse, delta, causal,
                                             scale)
                    pdk, pdv = tfa.flash_dkv_plain(q, k, v, g, plse, delta,
                                                   causal, scale)
                    _, truth = float64_grads(q, k, v, g, causal, scale)
                    tag = f"flash bh={bh} t={t} d={d} causal={causal}"
                    worst["fwd"] = max(worst["fwd"], flash_close(
                        ko, po, out_tol(po), tag + " O"))
                    worst["lse"] = max(worst["lse"], flash_close(
                        klse, plse, 1e-5 * (1 + plse.abs()), tag + " lse"))
                    for got, want, exact, name in (
                            (kdq, pdq, truth[0], "dq"),
                            (kdk, pdk, truth[1], "dk"),
                            (kdv, pdv, truth[2], "dv")):
                        pe = float((want.double() - exact).abs().max())
                        worst["plain_vs_float64"] = max(
                            worst["plain_vs_float64"], pe)
                        key = "dq" if name == "dq" else "dkv"
                        worst[key] = max(worst[key], flash_close(
                            got, want, grad_tol(want, pe), f"{tag} {name}"))
                    n += 1
    return {"cases": n, "max_abs_err": worst,
            "tolerance": "O 1e-4*max|O|+1e-6; lse 1e-5*(1+|lse|); grads "
                         "1e-3*max|g|+max(1e-5, 4*|plain-float64|)"}


def stage_qkv(svc, sid: int, tokens: int, seed: int):
    """Write ``tokens`` rows (key = global position, value = fused
    ``q|k|v`` float32 [3 * heads * head_dim], standard normal) from
    ATTN_MAPS map tasks, positions permuted across maps; range partitions
    of ``tokens / SHARDS`` positions, one per logical shard."""
    rng = np.random.default_rng(seed)
    lanes = 3 * ATTN_HEADS * ATTN_HEAD_DIM
    qkv = rng.standard_normal((tokens, lanes), dtype=np.float32)
    pos = rng.permutation(tokens)
    t = tokens // SHARDS
    h = svc.register_shuffle(sid, ATTN_MAPS, SHARDS, "range",
                             bounds=[t * (i + 1) for i in range(SHARDS - 1)])
    per = tokens // ATTN_MAPS
    for m in range(ATTN_MAPS):
        sel = pos[m * per:(m + 1) * per]
        svc.write(h, m, sel.astype(np.int64), qkv[sel])
    return h, qkv


def global_qkv(qkv, dev):
    """The written rows as q, k, v ``[1, heads, tokens, head_dim]`` on the
    card (what the decode must restore)."""
    import torch
    x = torch.from_numpy(qkv).to(dev).view(
        qkv.shape[0], 3, ATTN_HEADS, ATTN_HEAD_DIM)
    return tuple(x[:, i].permute(1, 0, 2)[None].contiguous()
                 for i in range(3))


def profiled_consume(svc, h, step) -> dict:
    """One more device-sink read + consume under torch.profiler."""
    import torch
    with device_profile() as prof:
        t0 = time.perf_counter()
        res = svc.read(h, ordered=True, sink="device")
        torch.cuda.synchronize()
        read_ms = (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        out = res.consume(lambda c, rows, totals: step(rows, totals))
        torch.cuda.synchronize()
        consume_ms = (time.perf_counter() - t1) * 1e3
    del out
    wall = read_ms + consume_ms
    return {"wall_ms": wall, "read_ms": read_ms, "consume_ms": consume_ms,
            **device_busy(prof, wall)}


def ulysses_phase(dev) -> tuple:
    """One attention layer of LLaMA-2-7B-32K (32 heads x 128, its 32,768
    token context, causal) fed by a range-partitioned device-sink read of
    fused q|k|v rows and consumed by the Ulysses consumer: D2H 0,
    ragged_a2a 1 and flash_fwd 1; the decoded q, k, v equal the written
    rows and O is within 1e-4 max|O| + 1e-6 of the plain forward."""
    import torch
    from sparkucx_tpu_torch import backend, connect
    from sparkucx_tpu_torch.ops import flash_attention as tfa
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME
    from sparkucx_tpu_torch.parallel.ring import decode_qkv_rows, unshard_seq
    from sparkucx_tpu_torch.parallel.ulysses import \
        ulysses_attention_consumer
    t_shard = ATTN_TOKENS // SHARDS
    conf = {"spark.shuffle.tpu.a2a.impl": "pallas"}
    t = time.perf_counter()
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        h, qkv = stage_qkv(svc, 40, ATTN_TOKENS, SEED + 40)
        write_s = time.perf_counter() - t
        step = ulysses_attention_consumer(SHARDS, t_shard, ATTN_HEADS,
                                          ATTN_HEAD_DIM, causal=True)
        box = {}

        def consume(carry, rows, totals):
            t0 = time.perf_counter()
            out = step(rows, totals)
            torch.cuda.synchronize()
            box["step_ms"] = (time.perf_counter() - t0) * 1e3
            box["qkv"] = decode_qkv_rows(rows, totals, t_shard, ATTN_HEADS,
                                         ATTN_HEAD_DIM)
            return out

        torch.cuda.reset_peak_memory_stats(dev)
        backend.reset_launch_counts()
        t0 = time.perf_counter()
        res = svc.read(h, ordered=True, sink="device")
        torch.cuda.synchronize()
        read_ms = (time.perf_counter() - t0) * 1e3
        out = res.consume(consume)
        launches = backend.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        rep = svc.report(40)
        expect_launches("ulysses_attention", {"all_launches": launches},
                        {KERNEL_NAME: 1, tfa.FWD_KERNEL_NAME: 1})
        if rep.d2h_bytes != 0 or rep.sink != "device":
            raise AssertionError(f"ulysses_attention: sink {rep.sink}, "
                                 f"d2h {rep.d2h_bytes}")
        prof = profiled_consume(svc, h, step)
        svc.unregister_shuffle(40)
    q, k, v = (unshard_seq(x) for x in box.pop("qkv"))
    for got, want, name in zip((q, k, v), global_qkv(qkv, dev), "qkv"):
        if not torch.equal(got, want):
            raise AssertionError(f"ulysses_attention: decoded {name} differs "
                                 f"from the written rows")
    del qkv
    H, T, D = ATTN_HEADS, ATTN_TOKENS, ATTN_HEAD_DIM
    scale = D ** -0.5
    t = time.perf_counter()
    po, plse = tfa.flash_fwd_plain(q.reshape(H, T, D), k.reshape(H, T, D),
                                   v.reshape(H, T, D), True, scale)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    if tuple(out.shape) != (1, H, T, D) or not bool(out.isfinite().all()):
        raise AssertionError(f"ulysses_attention: O {tuple(out.shape)} "
                             f"not finite or misshapen")
    err = flash_close(out.reshape(H, T, D), po, out_tol(po),
                      "ulysses_attention O")
    stats = {
        "phase": "ulysses_attention", **attention_constants(),
        "tokens_per_shard": t_shard, "maps": ATTN_MAPS, "causal": True,
        "row_width": 2 + 3 * H * D,
        "payload_bytes": rep.payload_bytes, "impl": rep.impl,
        "plan_bucket": rep.plan_bucket, "retries": rep.retries,
        "read_ms": read_ms, "consume_ms": box["step_ms"],
        "pack_ms": rep.pack_ms, "dispatch_ms": rep.dispatch_ms,
        "group_ms": rep.group_ms, "d2h_bytes": rep.d2h_bytes,
        "peak_device_bytes": peak, "launches": launches,
        "max_abs_err": err, "max_abs_out": float(po.abs().max()),
        "plain_forward_s": plain_s, "write_s": write_s, "ok": True}
    prof = {"phase": "ulysses_attention_profile", **prof}
    return stats, prof, (q, k, v), (po, plse)


def ulysses_train_phase(dev, qkv, fwd_ref) -> tuple:
    """The same q, k, v as leaves through ulysses_attention(causal=True)
    and a backward of a fixed random cotangent: flash_fwd, flash_dq and
    flash_dkv once each; O, dq, dk, dv held against the plain versions."""
    import torch
    from sparkucx_tpu_torch import backend
    from sparkucx_tpu_torch.ops import flash_attention as tfa
    from sparkucx_tpu_torch.parallel.ulysses import ulysses_attention
    H, T, D = ATTN_HEADS, ATTN_TOKENS, ATTN_HEAD_DIM
    scale = D ** -0.5
    leaves = [x.clone().requires_grad_() for x in qkv]
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    cot = torch.randn(qkv[0].shape, generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    out = ulysses_attention(*leaves, SHARDS, causal=True)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    t1 = time.perf_counter()
    out.backward(cot)
    torch.cuda.synchronize()
    bwd_ms = (time.perf_counter() - t1) * 1e3
    launches = backend.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    expect_launches("ulysses_attention_train",
                    {"all_launches": launches},
                    {tfa.FWD_KERNEL_NAME: 1, tfa.DQ_KERNEL_NAME: 1,
                     tfa.DKV_KERNEL_NAME: 1})
    po, plse = fwd_ref
    flat = [x.detach().reshape(H, T, D) for x in qkv]
    gf = cot.reshape(H, T, D)
    delta = (gf * po).sum(dim=-1)
    t = time.perf_counter()
    pdq = tfa.flash_dq_plain(*flat, gf, plse, delta, True, scale)
    pdk, pdv = tfa.flash_dkv_plain(*flat, gf, plse, delta, True, scale)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    errs = {"O": flash_close(out.detach().reshape(H, T, D), po, out_tol(po),
                             "train O")}
    for leaf, want, name in zip(leaves, (pdq, pdk, pdv), ("dq", "dk", "dv")):
        errs[name] = flash_close(leaf.grad.reshape(H, T, D), want,
                                 grad_tol(want), f"train {name}")
    del leaves, out
    return {"phase": "ulysses_attention_train", **attention_constants(),
            "causal": True, "forward_ms": fwd_ms, "backward_ms": bwd_ms,
            "peak_device_bytes": peak, "launches": launches,
            "max_abs_err": errs, "plain_backward_s": plain_s,
            "ok": True}, cot, (pdq, pdk, pdv)


def ring_phase(dev) -> dict:
    """The ring consumer at T = 8,192 (1,024 tokens per shard, same width)
    on one device-sink read, held against the Ulysses consumer's O on the
    same rows."""
    import torch
    from sparkucx_tpu_torch import backend, connect
    from sparkucx_tpu_torch.parallel.ring import ring_attention_consumer
    from sparkucx_tpu_torch.parallel.ulysses import \
        ulysses_attention_consumer
    t_shard = RING_TOKENS // SHARDS
    conf = {"spark.shuffle.tpu.a2a.impl": "pallas"}
    ring = ring_attention_consumer(SHARDS, t_shard, ATTN_HEADS,
                                   ATTN_HEAD_DIM, causal=True)
    uly = ulysses_attention_consumer(SHARDS, t_shard, ATTN_HEADS,
                                     ATTN_HEAD_DIM, causal=True)
    box = {}

    def consume(carry, rows, totals):
        backend.reset_launch_counts()
        t0 = time.perf_counter()
        box["ring"] = ring(rows, totals)
        torch.cuda.synchronize()
        box["ring_ms"] = (time.perf_counter() - t0) * 1e3
        box["ring_launches"] = backend.launch_counts()
        t1 = time.perf_counter()
        box["ulysses"] = uly(rows, totals)
        torch.cuda.synchronize()
        box["ulysses_ms"] = (time.perf_counter() - t1) * 1e3

    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        h, qkv = stage_qkv(svc, 42, RING_TOKENS, SEED + 42)
        res = svc.read(h, ordered=True, sink="device")
        res.consume(consume)
        rep = svc.report(42)
        svc.unregister_shuffle(42)
    if rep.d2h_bytes != 0:
        raise AssertionError("ring_attention: the read paid a D2H")
    o_ring, o_uly = box["ring"], box["ulysses"]
    if not bool(o_ring.isfinite().all()):
        raise AssertionError("ring_attention: O not finite")
    err = flash_close(o_ring, o_uly, out_tol(o_uly),
                      "ring_attention O against Ulysses")
    return {"phase": "ring_attention", "heads": ATTN_HEADS,
            "head_dim": ATTN_HEAD_DIM, "tokens": RING_TOKENS,
            "shards": SHARDS, "causal": True, "ring_ms": box["ring_ms"],
            "ulysses_ms": box["ulysses_ms"],
            "ring_launches": box["ring_launches"], "max_abs_err": err,
            "ok": True}


def flash_bounds(H: int, T: int, D: int, causal: bool) -> dict:
    """Least times for the function (not the kernels' recomputation):
    4 D flops per live (q, k) pair forward, 10 D backward
    (FlashAttention-2's accounting), split 2 D to dq's product and 8 D to
    dk/dv (S, dP, dV, dK). ``bound_ms`` takes the operations at the
    split-TF32 rate (a third of the TF32 tensor-core rate: the rate at
    which the card computes float32-accurate products, which the three
    kernels use), or the bytes (each input read once, each output written
    once) where those take longer; beside it, the operations at the
    float32 rate outside the tensor cores and at the single-pass TF32
    rate."""
    pairs = H * T * (T + 1) // 2 if causal else H * T * T
    mat = H * T * D * 4
    row = H * T * 4
    flops = {"flash_fwd": 4 * D * pairs, "flash_dq": 2 * D * pairs,
             "flash_dkv": 8 * D * pairs}
    byts = {"flash_fwd": 3 * mat + mat + row,
            "flash_dq": 4 * mat + 2 * row + mat,
            "flash_dkv": 4 * mat + 2 * row + 2 * mat}
    out = {}
    for name in flops:
        op_ms = flops[name] / SPLIT_TF32_FLOPS_PER_S * 1e3
        byte_ms = byts[name] / HBM_BYTES_PER_S * 1e3
        out[name] = {"flops": flops[name], "bytes": byts[name],
                     "bound_ms": max(op_ms, byte_ms),
                     "bound_by": "operations" if op_ms >= byte_ms
                     else "bytes",
                     "bound_fp32_simt_ms": flops[name] / FP32_FLOPS_PER_S
                     * 1e3,
                     "bound_tf32_ms": flops[name] / TF32_FLOPS_PER_S * 1e3,
                     "bound_bytes_ms": byte_ms}
    out["backward_flops"] = 10 * D * pairs
    out["backward_bound_ms"] = 10 * D * pairs / SPLIT_TF32_FLOPS_PER_S * 1e3
    out["backward_bound_fp32_simt_ms"] = \
        10 * D * pairs / FP32_FLOPS_PER_S * 1e3
    return out


def flash_at_main_shapes(dev, qkv, cot, fwd_ref, bwd_ref) -> dict:
    """The three kernels at the ulysses_attention shape ([32, 32768, 128],
    causal): kernel, plain version and the SDPA yardstick
    (memory-efficient backend, float32; its backward for dq/dk/dv
    together), CUDA-event medians (7 forward, 3 backward and plain), with
    the bounds of :func:`flash_bounds`."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from sparkucx_tpu_torch.ops import flash_attention as tfa
    H, T, D = ATTN_HEADS, ATTN_TOKENS, ATTN_HEAD_DIM
    scale = D ** -0.5
    q, k, v = (x.detach().reshape(H, T, D).contiguous() for x in qkv)
    g = cot.reshape(H, T, D).contiguous()
    po, plse = fwd_ref
    delta = (g * po).sum(dim=-1)
    ko, klse = tfa.flash_fwd_kernel(q, k, v, True, scale)
    kdq = tfa.flash_dq_kernel(q, k, v, g, plse, delta, True, scale)
    kdk, kdv = tfa.flash_dkv_kernel(q, k, v, g, plse, delta, True, scale)
    torch.cuda.synchronize()
    pdq, pdk, pdv = bwd_ref            # the plain backward on these inputs
    err = {"flash_fwd": flash_close(ko, po, out_tol(po), "main-shape O"),
           "lse": flash_close(klse, plse, 1e-5 * (1 + plse.abs()),
                              "main-shape lse"),
           "flash_dq": flash_close(kdq, pdq, grad_tol(pdq), "main-shape dq"),
           "dk": flash_close(kdk, pdk, grad_tol(pdk), "main-shape dk"),
           "dv": flash_close(kdv, pdv, grad_tol(pdv), "main-shape dv")}
    err["flash_dkv"] = max(err["dk"], err["dv"])
    del ko, klse, kdq, kdk, kdv
    ms = {
        "flash_fwd": median_ms(lambda: tfa.flash_fwd_kernel(
            q, k, v, True, scale), reps=7, warmup=1),
        "flash_dq": median_ms(lambda: tfa.flash_dq_kernel(
            q, k, v, g, plse, delta, True, scale), reps=3, warmup=1),
        "flash_dkv": median_ms(lambda: tfa.flash_dkv_kernel(
            q, k, v, g, plse, delta, True, scale), reps=3, warmup=1)}
    plain_ms = {
        "flash_fwd": median_ms(lambda: tfa.flash_fwd_plain(
            q, k, v, True, scale), reps=3, warmup=0),
        "flash_dq": median_ms(lambda: tfa.flash_dq_plain(
            q, k, v, g, plse, delta, True, scale), reps=3, warmup=0),
        "flash_dkv": median_ms(lambda: tfa.flash_dkv_plain(
            q, k, v, g, plse, delta, True, scale), reps=3, warmup=0)}
    # the yardstick: one SDPA call on the same inputs ([1, H, T, D])
    lib = {"name": "scaled_dot_product_attention(is_causal=True), "
                   "EFFICIENT_ATTENTION backend, float32; backward: "
                   "autograd.grad of that call for dq, dk, dv together"}
    leaves = [x[None].clone().requires_grad_() for x in (q, k, v)]
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        lo = F.scaled_dot_product_attention(*leaves, is_causal=True)
        lib["max_abs_diff_vs_plain"] = float((lo[0].detach() - po).abs().max())
        # the yardstick's own distance from the plain backward, beside the
        # kernels' (max_abs_err)
        lib["backward_max_abs_diff_vs_plain"] = {
            name: float((got[0] - want).abs().max()) for name, got, want in
            zip(("dq", "dk", "dv"), torch.autograd.grad(
                lo, leaves, g[None], retain_graph=True), (pdq, pdk, pdv))}
        del pdq, pdk, pdv, bwd_ref
        lib["forward_ms"] = median_ms(
            lambda: F.scaled_dot_product_attention(*leaves, is_causal=True),
            reps=7, warmup=1)
        lib["backward_ms"] = median_ms(lambda: torch.autograd.grad(
            lo, leaves, g[None], retain_graph=True), reps=3, warmup=1)
    del lo, leaves
    bounds = flash_bounds(H, T, D, True)
    return {"shape": [H, T, D], "causal": True, "kernel_ms": ms,
            "plain_ms": plain_ms, "library": lib, "bounds": bounds,
            "max_abs_err": err,
            "forward_vs_sdpa": ms["flash_fwd"] / lib["forward_ms"],
            "backward_kernel_ms": ms["flash_dq"] + ms["flash_dkv"],
            "backward_vs_sdpa": (ms["flash_dq"] + ms["flash_dkv"])
            / lib["backward_ms"],
            "reps": {"forward": 7, "backward": 3, "plain": 3}}


# -- workloads: the analytics runners under the default conf --------------
# (name, module under workloads/, runner, arguments): the widths of each
# source, its scale cut to one card (PERF.md section 4 lists the cuts)
WORKLOAD_RUNS = [
    ("terasort_range", "terasort", "run_terasort",
     dict(mode="range", num_mappers=64, rows_per_mapper=163_840,
          num_partitions=200)),
    ("terasort_direct", "terasort", "run_terasort",
     dict(mode="direct", num_mappers=64, rows_per_mapper=163_840,
          num_partitions=200)),
    ("groupby", "groupby", "run_groupby",
     dict(num_mappers=64, pairs_per_mapper=163_840, num_partitions=200,
          key_space=2_097_152, value_width=4)),
    ("wordcount", "wordcount", "run_wordcount",
     dict(num_mappers=64, words_per_mapper=163_840, vocab=1000,
          num_partitions=200)),
    ("wordcount_text", "wordcount", "run_wordcount_text",
     dict(num_mappers=64, words_per_mapper=65_536, num_partitions=200)),
    ("pagerank", "pagerank", "run_pagerank",
     dict(num_vertices=875_713, num_edges=5_105_039, num_mappers=64,
          num_partitions=200, iterations=10)),
    ("als", "als", "run_als",
     dict(num_users=6040, num_items=3706, num_ratings=1_000_209, rank=10,
          iterations=10, reg=0.1, num_mappers=64, num_partitions=200)),
    ("tc", "tc", "run_tc",
     dict(num_vertices=100, num_edges=200, max_iters=200)),
    ("q23", "q23", "run_q23",
     dict(num_mappers=64, sales_rows=10_485_760, probe_rows=10_485_760,
          item_space=204_000, frequency_threshold=100,
          num_partitions=200)),
    ("join", "join", "run_join",
     dict(num_mappers=64, build_rows=2_621_440, probe_rows=10_485_760,
          key_space=2_097_152, num_partitions=200)),
    ("join_varchar", "join", "run_join_varchar",
     dict(num_mappers=64, build_rows=1_048_576, probe_rows=4_194_304,
          vocab_size=1_000_000, num_partitions=200)),
]


class ReadTally:
    """Counts a manager's reads while installed: reads, combine reads,
    the overflow retries of each kind (``report(sid).retries``), the rows
    they moved, the impls they ran and the wall spent inside them."""

    def __init__(self, manager):
        self.manager = manager
        self.reads = self.combine_reads = 0
        self.retries = self.combine_retries = 0
        self.rows = 0
        self.read_s = 0.0
        self.impls = set()

    def __enter__(self) -> "ReadTally":
        inner = self.manager.read

        def read(handle, *args, **kw):
            t0 = time.perf_counter()
            res = inner(handle, *args, **kw)
            self.read_s += time.perf_counter() - t0
            rep = self.manager.report(handle.shuffle_id)
            self.reads += 1
            self.retries += rep.retries
            if kw.get("combine"):
                self.combine_reads += 1
                self.combine_retries += rep.retries
            self.rows += rep.rows_global
            self.impls.add(rep.impl)
            return res

        self.manager.read = read
        return self

    def __exit__(self, *exc) -> None:
        del self.manager.read


def _card_copy(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return tuple(_card_copy(t) for t in x)
    return x


class KernelCapture:
    """While installed, keeps a device copy of the inputs and the output
    of the first launch of the segment move (B.1), the merge (B.2), the
    segment reduce (B.3), the fused dequant reduce (B.4) and the quantize
    (B.5), and references to those
    of the latest launch; :meth:`check` then holds the first and the last launch
    against the plain version on the same inputs, at the shapes the run
    gave the kernel. The first launch's copy is made on the stream right
    after it and adds its bytes (:meth:`nbytes`) to the device peak; a
    later launch is not copied, so the run's copy traffic is one launch
    a kernel, and its tensors live until the next launch or the check.
    No launch is added to the counts."""

    def __init__(self):
        self.calls = {}            # kernel name -> [first, last] (args, out)

    def __enter__(self) -> "KernelCapture":
        from sparkucx_tpu_torch.ops import quant as tq
        from sparkucx_tpu_torch.ops import ragged_a2a as ra
        from sparkucx_tpu_torch.ops import segmented as sg
        self._saved = []
        for mod, attr, name in ((ra, "ragged_a2a_kernel", ra.KERNEL_NAME),
                                (sg, "segment_reduce_kernel",
                                 sg.KERNEL_NAME),
                                (sg, "merge_kernel", sg.MERGE_KERNEL_NAME),
                                (sg, "segment_reduce_wire_kernel",
                                 sg.WIRE_KERNEL_NAME),
                                (tq, "quantize_kernel", tq.KERNEL_NAME)):
            orig = getattr(mod, attr)
            self._saved.append((mod, attr, orig))

            def launch(*args, _orig=orig, _name=name):
                out = _orig(*args)
                seen = self.calls.setdefault(_name, [])
                if seen:
                    seen[1:] = [(args, out)]
                else:
                    seen.append((_card_copy(args), _card_copy(out)))
                return out

            setattr(mod, attr, launch)
        return self

    def __exit__(self, *exc) -> None:
        for mod, attr, orig in self._saved:
            setattr(mod, attr, orig)

    def nbytes(self) -> int:
        """Bytes of the first launches' copies."""
        import torch
        return sum(t.numel() * t.element_size()
                   for calls in self.calls.values() for args, out in calls[:1]
                   for t in (*args, *out) if isinstance(t, torch.Tensor))

    def check(self, tag: str) -> dict:
        """{kernel: {calls, widths, rows, max_abs_err}}: ``calls`` is the
        number of captured launches held against the plain version (an
        overflowed segment move writes nothing and is not compared),
        ``rows`` the largest send or input row count among them."""
        from sparkucx_tpu_torch.ops import quant as tq
        from sparkucx_tpu_torch.ops import ragged_a2a as ra
        from sparkucx_tpu_torch.ops import segmented as sg
        out = {}
        for name, calls in self.calls.items():
            n, widths, rows, err = 0, set(), 0, 0.0
            for i, (args, got) in enumerate(calls):
                what = f"{tag}: {name} launch {'first last'.split()[i]}"
                if name == ra.KERNEL_NAME:
                    if bool(args[4]):
                        continue
                    err = max(err, check_segment_move(what, args, got))
                elif name == sg.MERGE_KERNEL_NAME:
                    check_merge(what, args, got)
                elif name == tq.KERNEL_NAME:
                    check_quantize(what, args, got)
                elif name == sg.WIRE_KERNEL_NAME:
                    err = max(err, check_segment_reduce_wire(what, args,
                                                             got))
                else:
                    err = max(err, check_segment_reduce(what, args, got))
                n += 1
                widths.add(int(args[0].shape[-1]))
                rows = max(rows, int(args[0].shape[-2]))
            if not n:
                raise AssertionError(f"{tag}: no launch of {name} was "
                                     "compared with its plain version")
            out[name] = {"calls": n, "widths": sorted(widths), "rows": rows,
                         "max_abs_err": err}
        self.calls.clear()
        return out


def check_segment_move(tag: str, args, got) -> int:
    """Hold the segment move's output for ``args`` = (send, in_off, in_sz,
    out_off, overflow, out_capacity) against the plain version: every row
    a segment covers (each receiver's aligned prefix) exactly equal."""
    import torch
    from sparkucx_tpu_torch.ops import ragged_a2a as ra
    plain = ra.ragged_a2a_plain(*args)
    torch.cuda.synchronize()
    total = args[2].sum(dim=0).tolist()     # aligned rows per receiver
    for q, t in enumerate(total):
        if not torch.equal(got[q, :t], plain[q, :t]):
            raise AssertionError(f"{tag}: receiver {q} differs from the "
                                 "plain version")
    return 0


def check_merge(tag: str, args, got) -> None:
    """Hold the merge kernel's (rows, part) for ``args`` = (a_rows,
    a_part, b_rows, b_part, out_cap) against ``merge_plain``: every row
    and partition id bit for bit."""
    import torch
    from sparkucx_tpu_torch.ops import segmented as sg
    want = sg.merge_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"{tag}: differs from merge_plain")


def check_quantize(tag: str, args, got) -> None:
    """Hold the quantize kernel's (q, scale) for ``args`` = (x, u) against
    ``quantize_plain``: byte for byte."""
    import torch
    from sparkucx_tpu_torch.ops import quant as tq
    q, scale = tq.quantize_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], q) and torch.equal(
            got[1].view(torch.int32), scale.view(torch.int32))):
        raise AssertionError(f"{tag}: differs from quantize_plain")


def workload_input_rows(fn: str, kw: dict, result: dict) -> int:
    """The rows of the job's input: records, words, edges, ratings, or
    both fact tables / join sides."""
    if fn in ("run_pagerank", "run_tc"):
        return result["edges"]
    if fn == "run_als":
        return kw["num_ratings"]
    if fn == "run_q23":
        return kw["sales_rows"] + kw["probe_rows"]
    if fn in ("run_join", "run_join_varchar"):
        return kw["build_rows"] + kw["probe_rows"]
    if fn.startswith("run_wordcount"):
        return result["total_words"]
    return result["rows"]


def workloads_phase(dev) -> dict:
    """Every analytics runner on one ``connect(num_shards=8)`` under the
    default conf, one after another; each runner's own oracle decides.
    Each runner gets a manager of its own over the service's node, as a
    separate job would, so the receive capacity one job learned does not
    spare the next its overflow (the join's hot keys must regrow). The
    runner runs under torch.profiler, whose device activities give the
    device's busy time and idle share of the runner's wall.
    Launch rule: the segment move runs once per read attempt (reads +
    overflow retries) and the segment reduce once per combine-read
    attempt, so nothing ran a plain version. The first and the last
    launch of each kernel in a runner are then held against the plain
    version on the same inputs (:class:`KernelCapture`)."""
    import importlib

    import torch
    from sparkucx_tpu_torch import backend, connect
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME as move
    from sparkucx_tpu_torch.ops.segmented import KERNEL_NAME as reduce
    from sparkucx_tpu_torch.shuffle.manager import ShuffleManager
    out = {}
    with connect(num_shards=SHARDS, use_env=False) as svc:
        for name, module, fn, kw in WORKLOAD_RUNS:
            run = getattr(importlib.import_module(
                f"sparkucx_tpu_torch.workloads.{module}"), fn)
            manager = ShuffleManager(svc.node, svc.conf)
            torch.cuda.reset_peak_memory_stats(dev)
            # device activities only: no host op is recorded, so the
            # tracing adds no per-op cost to the runner's host work
            with ReadTally(manager) as tally, KernelCapture() as capture, \
                    device_profile(cpu=False) as prof:
                backend.reset_launch_counts()
                t0 = time.perf_counter()
                result = run(manager, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = backend.launch_counts()
            manager.stop()
            peak = torch.cuda.max_memory_allocated(dev)
            captured = capture.nbytes()
            checks = capture.check(f"workload {name}")
            launches = {move: counts.get(move, 0),
                        reduce: counts.get(reduce, 0)}
            want = {move: tally.reads + tally.retries,
                    reduce: tally.combine_reads + tally.combine_retries}
            if launches != want or not tally.reads:
                raise AssertionError(
                    f"workload {name}: launches {launches}, want {want} "
                    f"({tally.reads} reads, {tally.retries} retries)")
            if set(checks) != {k for k, v in launches.items() if v}:
                raise AssertionError(f"workload {name}: checked {checks}, "
                                     f"launched {launches}")
            rows = workload_input_rows(fn, kw, result)
            line = {
                "phase": "workload", "name": name, "args": kw,
                "result": result, "wall_s": wall, "reads": tally.reads,
                "combine_reads": tally.combine_reads,
                "retries": tally.retries, "launches": launches,
                "rows_per_s": rows / wall, "input_rows": rows,
                "shuffled_rows": tally.rows, "read_s": tally.read_s,
                "impls": sorted(tally.impls),
                **device_busy(prof, wall * 1e3),
                "kernel_checks": checks,
                "peak_device_bytes": peak, "captured_bytes": captured,
                "pool_held_bytes": svc.node.pool.stats()["free_bytes"]}
            print(json.dumps(line), flush=True)
            out[name] = line
    return out


# -- the memory planes: spill, admission, external-memory pipelines -------
SPILL_THRESHOLD = "4m"
SPILL_CHUNK_ROWS = 8_192   # 20 writes a map: a spill after every 6 (4 a map)
RECORD_WORDS = 2 + VALUE_WORDS       # int64 key + the payload words
RECORD_BYTES = 4 * RECORD_WORDS
# (name, module, function, budget bytes = dataset bytes / 10, arguments):
# main's row count; the groupby and join shapes of wl_groupby and wl_join
# (key space 2,097,152); groupby in chunks of 24,576 rows, so each map's
# last 16,384 rows stay staged below its spill threshold and the pool
# valve engages as well
PIPELINE_RUNS = [
    ("terasort", "terasort", "terasort_pipeline", 10_485_760 * 8 // 10,
     dict(total_rows=10_485_760, num_mappers=64, num_partitions=200)),
    ("groupby_device", "groupby", "groupby_pipeline", 10_485_760 * 24 // 10,
     dict(total_rows=10_485_760, num_mappers=64, num_partitions=200,
          key_space=2_097_152, value_width=4, sink="device", warm_reads=1,
          chunk_rows=24_576)),
    ("groupby_host", "groupby", "groupby_pipeline", 10_485_760 * 24 // 10,
     dict(total_rows=10_485_760, num_mappers=64, num_partitions=200,
          key_space=2_097_152, value_width=4, sink="host", warm_reads=0,
          chunk_rows=24_576)),
    ("join", "join", "join_pipeline", 10_485_760 * 16 // 10,
     dict(total_rows=10_485_760, num_mappers=64, num_partitions=200,
          key_space=2_097_152)),
]

# the MoE cells: Switch-Base-8 (Fedus et al. 2021, arXiv:2101.03961; the
# released google/switch-base-8: d_model 768, expert FFN 3,072, 8 experts,
# top-1), capacity factor 2.0, 64 sequences of 512 tokens a step on a
# dp=2 x ep=4 grid of logical shards
MOE_D = 768
MOE_H = 3072
MOE_E = 8
MOE_DP, MOE_EP = 2, 4
MOE_TOKENS_PER_SHARD = 64 * 512 // (MOE_DP * MOE_EP)
MOE_CF = 2.0
MOE_STEPS = 5
MOE_LR = 1e-3
MOE_MAPS = 8
MOE_DISPATCH_READS = 5
# int8 forward against the float64 oracle: each of the two moves rounds a
# value by at most one step (amax_row/127, 0.8% of its row's largest);
# through the experts and wout this measured 1.8% of max|out| on the CPU
# at these widths (512 tokens)
MOE_INT8_TOL = 0.05
# float64 routing may split a near-tie the other way from the model's
# float32 routing: such tokens leave the comparison, at most this many
MOE_ORACLE_FLIPS = 3


def moe_config(wire: str):
    from sparkucx_tpu_torch.models import moe as tm
    return tm.MoEConfig(d_model=MOE_D, d_hidden=MOE_H, num_experts=MOE_E,
                        tokens_per_shard=MOE_TOKENS_PER_SHARD,
                        capacity_factor=MOE_CF, wire=wire)


def moe_inputs(dev):
    """(initial parameters, tokens x, targets y) on the card, from the
    smoke's seed."""
    import torch
    from sparkucx_tpu_torch.models import moe as tm
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 40)
    params = tm.init_params(moe_config("raw"), g, dev)
    B = MOE_DP * MOE_EP * MOE_TOKENS_PER_SHARD
    x = torch.randn(B, MOE_D, generator=g, device=dev)
    y = torch.randn(B, MOE_D, generator=g, device=dev) * 0.1
    return params, x, y


def moe_oracle(params, x):
    """The dense top-1 MoE of tests/test_moe.py in float64 on the card,
    each token through its own expert only: (output, expert ids)."""
    import torch
    import torch.nn.functional as F
    p = {k: v.double() for k, v in params.items()}
    xd = x.double()
    logits = xd @ p["router"]
    expert = torch.argmax(logits, dim=-1)
    gate = torch.softmax(logits, dim=-1).gather(1, expert[:, None])[:, 0]
    own = torch.zeros_like(xd)
    for e in range(MOE_E):
        idx = torch.nonzero(expert == e)[:, 0]
        own[idx] = F.gelu(xd[idx] @ p["w1"][e], approximate="tanh") \
            @ p["w2"][e]
    return (own * gate[:, None]) @ p["wout"], expert


def moe_forward_check(got, want, oracle_expert, model_expert,
                      wire: str) -> dict:
    """The forward against the float64 oracle on the tokens both route
    alike: raw within 2e-5 + 2e-4 |want| (tests/test_moe.py's bound),
    int8 within MOE_INT8_TOL of max|want|."""
    import torch
    same = oracle_expert == model_expert
    flips = int((~same).sum())
    err = (got.double() - want).abs()[same]
    scale = float(want.abs().max())
    max_err = float(err.max())
    if wire == "raw":
        worst = float((err / (2e-5 + 2e-4 * want.abs()[same])).max())
        ok = worst <= 1.0
    else:
        worst = max_err / (MOE_INT8_TOL * scale)
        ok = worst <= 1.0
    if flips > MOE_ORACLE_FLIPS or not ok or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"moe_train {wire}: forward against the "
                             f"oracle: max err {max_err} (worst/bound "
                             f"{worst}), routing flips {flips}")
    return {"max_abs_err": max_err, "max_abs_out": scale,
            "err_over_bound": worst, "oracle_routing_flips": flips}


def routing_disagreements(params, x, cfg, dp: int, ep: int) -> dict:
    """Check of the raw wire's recomputed routing: dispatch ``x`` as the
    model's forward does, move each token's sender-side expert id beside
    it (an exact id exchange the model itself does not run), recompute
    the expert on the received rows and count the received rows whose
    expert differs; such a row would go to another expert or drop without
    an error. ``{"rows": received rows, "disagree": n}``."""
    import torch
    from sparkucx_tpu_torch.models import moe as tm
    from sparkucx_tpu_torch.shuffle.alltoall import exchange, group_shuffle
    cap = cfg.recv_capacity
    with torch.no_grad():
        xs = x.reshape(dp, ep, cfg.tokens_per_shard, cfg.d_model)
        _, expert, order, _, x_sorted, counts = tm._route(params, xs, cfg,
                                                          ep)
        recv = exchange(x_sorted, counts, cap, cfg.impl)
        sent, recv_sizes, _ = group_shuffle(
            torch.gather(expert.to(torch.int32), -1, order)[..., None],
            counts, cap, cfg.impl)
        again = torch.argmax(tm.router_logits(recv, params["router"]), -1)
        valid = torch.arange(cap, device=x.device) \
            < recv_sizes.sum(dim=-1, keepdim=True)
        return {"rows": int(valid.sum()),
                "disagree": int((valid & (again != sent[..., 0])).sum())}


def traced_kernel_ms(prof, name: str) -> list:
    """Device ms of each traced launch of the kernel whose symbol holds
    ``name``, in launch order."""
    import torch
    evts = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and name in e.name]
    evts.sort(key=lambda e: e.time_range.start)
    return [(e.time_range.end - e.time_range.start) / 1e3 for e in evts]


def _timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def moe_train_phase(dev) -> tuple:
    """Switch-Base-8's MoE layer trained on the dp x ep grid on each wire:
    the forward against the float64 oracle, five Adam steps (walls,
    losses, peak device bytes, quantize launches), the raw wire's
    recomputed routing against the senders', and on the int8 wire the
    first and last quantize launch held against ``quantize_plain``."""
    import torch
    from sparkucx_tpu_torch import backend
    from sparkucx_tpu_torch.models import moe as tm
    from sparkucx_tpu_torch.ops import quant as tq
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME as move
    params0, x, y = moe_inputs(dev)
    want, oracle_expert = moe_oracle(params0, x)
    with torch.no_grad():
        model_expert = torch.argmax(tm.router_logits(x, params0["router"]),
                                    dim=-1)
    out = {"tokens": int(x.shape[0]), "grid": [MOE_DP, MOE_EP],
           "d_model": MOE_D, "d_hidden": MOE_H, "experts": MOE_E,
           "capacity_factor": MOE_CF,
           "recv_capacity": moe_config("raw").recv_capacity}
    for wire in ("raw", "int8"):
        cfg = moe_config(wire)
        with KernelCapture() as capture:
            with torch.no_grad():
                got, _ = _timed(lambda: tm.forward(params0, x, cfg, MOE_DP,
                                                   MOE_EP))
                fwd_ms = float(np.median([_timed(lambda: tm.forward(
                    params0, x, cfg, MOE_DP, MOE_EP))[1] for _ in range(3)]))
            check = moe_forward_check(got, want, oracle_expert,
                                      model_expert, wire)
            del got
            init, step = tm.make_train_step(cfg, MOE_DP, MOE_EP, lr=MOE_LR,
                                            device=dev)
            params, opt = init(params0)
            torch.cuda.reset_peak_memory_stats(dev)
            backend.reset_launch_counts()
            losses, walls = [], []
            for _ in range(MOE_STEPS):
                (params, opt, loss), ms = _timed(
                    lambda: step(params, opt, x, y))
                losses.append(float(loss))
                walls.append(ms)
            counts = backend.launch_counts()
            peak = torch.cuda.max_memory_allocated(dev)
        # one more step under device-activity tracing: where its time goes
        with device_profile(cpu=False) as prof:
            _, prof_ms = _timed(lambda: step(params, opt, x, y))
        # int8: the dispatch, the combine and the combine's backward, one
        # launch each for all 8 shards; the dispatch's backward does not
        # run (the tokens are not differentiated)
        quant = counts.get(tq.KERNEL_NAME, 0)
        want_quant = 3 * MOE_STEPS if cfg.wire_int8 else 0
        if quant != want_quant or counts.get(move, 0):
            raise AssertionError(f"moe_train {wire}: launches {counts}, "
                                 f"want quantize {want_quant}")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"moe_train {wire}: losses {losses}")
        line = {"forward_ms": fwd_ms, "step_ms": float(np.median(walls)),
                "step_walls_ms": walls, "losses": losses,
                "peak_device_bytes": peak, "quantize_launches": quant,
                "quantize_per_step": quant / MOE_STEPS,
                "captured_bytes": capture.nbytes(), "forward": check,
                "profiled_step": {"wall_ms": prof_ms,
                                  **device_busy(prof, prof_ms)}}
        if cfg.wire_int8:
            # the dispatch (dp*ep*T rows), the combine (dp*ep*cap rows)
            # and the combine's backward (dp*ep*T rows), each x d_model
            # (the trace may hold fewer launches than were made)
            q_ms = traced_kernel_ms(prof, QUANT_DEVICE_KERNEL)
            B = MOE_DP * MOE_EP
            line["profiled_step"]["quantize_device_ms"] = {
                "rows": [B * MOE_TOKENS_PER_SHARD, B * cfg.recv_capacity,
                         B * MOE_TOKENS_PER_SHARD],
                "width": MOE_D, "ms": q_ms, "sum_ms": float(sum(q_ms))}
        if cfg.wire_int8:
            line["kernel_checks"] = capture.check("moe_train int8")
        else:
            # the receiver's recomputed expert against the sender's, with
            # the initial and the trained router
            line["routing"] = {
                "initial": routing_disagreements(
                    params0, x, cfg, MOE_DP, MOE_EP),
                "trained": routing_disagreements(
                    {k: v.detach() for k, v in params.items()}, x, cfg,
                    MOE_DP, MOE_EP)}
            bad = {k: v for k, v in line["routing"].items() if v["disagree"]}
            if bad:
                raise AssertionError(f"moe_train raw: received rows route "
                                     f"to another expert: {bad}")
        out[wire] = line
        del params, opt, init, step
    out["int8_quantize_launches"] = out["int8"]["quantize_launches"]
    return out, params0, x


def moe_dispatch_phase(dev, params0, x) -> dict:
    """The read-path expert dispatch: the moe_train tokens staged by their
    Switch-Base-8 expert (``partitioner="direct"``, 8 experts as
    partitions, 8 maps), read with ``sink="device"`` under
    ``a2a.impl=pallas`` (the segment move, compacted) and consumed by
    ``make_device_dispatch_step`` over five fresh reads, then one read
    under the default conf (dense) from the same weights, then the
    host-staged arm on a host-sink read."""
    import torch
    from sparkucx_tpu_torch import backend, connect
    from sparkucx_tpu_torch.models import moe as tm
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME as move
    from sparkucx_tpu_torch.utils.metrics import C_D2H, C_H2D
    cfg = tm.MoEConfig(d_model=MOE_D, d_hidden=MOE_H, num_experts=MOE_E)
    with torch.no_grad():
        eids = torch.argmax(x @ params0["router"], dim=-1).cpu().numpy()
    tokens = x.cpu().numpy()
    width = 2 + MOE_D
    steps = {}

    def step_for(cap):
        if cap not in steps:
            steps[cap] = tm.make_device_dispatch_step(cfg, cap, SHARDS,
                                                      device=dev)
        return steps[cap]

    def consume(res, params):
        cap = int(res.device_rows().shape[1])
        step = step_for(cap)[1]
        return res.consume(lambda c, rows, totals: step(c[0], rows, totals),
                           (params, None)), cap

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 41)
    out = {"tokens": int(tokens.shape[0]), "maps": MOE_MAPS,
           "partitions": MOE_E, "width": width,
           "expert_rows": np.bincount(eids, minlength=MOE_E).tolist()}
    sid = 60
    pallas = {"spark.shuffle.tpu.a2a.impl": "pallas"}
    with connect(pallas, num_shards=SHARDS, use_env=False) as svc:
        h = svc.register_shuffle(sid, MOE_MAPS, MOE_E, partitioner="direct")
        tm.stage_tokens_by_expert(svc.manager, h, tokens, eids)
        metrics = svc.node.metrics
        # warm the read's and the step's torch ops (not counted, not timed)
        res = svc.read(h, sink="device")
        w0 = step_for(int(res.device_rows().shape[1]))[0](g)
        consume(res, w0)
        d2h0 = metrics.get(C_D2H)
        reads, consumes, losses, caps = [], [], [], []
        params = w0
        with KernelCapture() as capture:
            backend.reset_launch_counts()
            for _ in range(MOE_DISPATCH_READS):
                res, ms = _timed(lambda: svc.read(h, sink="device"))
                reads.append(ms)
                ((params, loss), cap), ms = _timed(
                    lambda: consume(res, params))
                consumes.append(ms)
                losses.append(float(loss))
                caps.append(cap)
            counts = backend.launch_counts()
        d2h = metrics.get(C_D2H) - d2h0
        rep = svc.report(sid)
        captured = capture.nbytes()
        checks = capture.check("moe_dispatch")
        if counts.get(move, 0) != MOE_DISPATCH_READS or d2h:
            raise AssertionError(f"moe_dispatch: launches {counts}, D2H "
                                 f"{d2h}; want {MOE_DISPATCH_READS} "
                                 f"segment moves and no D2H")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"moe_dispatch: losses {losses}")
        # one more read and consume under device-activity tracing
        with device_profile(cpu=False) as prof:
            _, prof_ms = _timed(lambda: consume(
                svc.read(h, sink="device"), params))
        profiled = {"wall_ms": prof_ms, **device_busy(prof, prof_ms)}
        h2d0 = metrics.get(C_H2D)
        rh, host_read_ms = _timed(lambda: svc.read(h, sink="host"))
        (_, host_loss), host_ms = _timed(lambda: tm.host_staged_consume(
            rh, step_for(caps[0])[1], w0, caps[0], width, SHARDS, metrics))
        h2d = metrics.get(C_H2D) - h2d0
        svc.unregister_shuffle(sid)
    with connect(num_shards=SHARDS, use_env=False) as svc:
        h = svc.register_shuffle(sid, MOE_MAPS, MOE_E, partitioner="direct")
        tm.stage_tokens_by_expert(svc.manager, h, tokens, eids)
        backend.reset_launch_counts()
        dres, dense_read_ms = _timed(lambda: svc.read(h, sink="device"))
        ((_, dense_loss), dense_cap), dense_ms = _timed(
            lambda: consume(dres, w0))
        dense_counts = backend.launch_counts()
        dense_impl = svc.report(sid).impl
        svc.unregister_shuffle(sid)
    first = losses[0]
    rel = {"host_staged": abs(float(host_loss) - first) / first,
           "dense": abs(float(dense_loss) - first) / first}
    if rel["host_staged"] > 1e-5 or rel["dense"] > 1e-5 or h2d <= 0 \
            or dense_counts.get(move, 0) or dense_impl != "dense":
        raise AssertionError(f"moe_dispatch: host-staged / dense first "
                             f"loss off by {rel}, H2D {h2d}, dense read "
                             f"{dense_impl} launches {dense_counts}")
    out.update({
        "pallas": {"impl": rep.impl, "read_ms": reads,
                   "consume_ms": consumes, "losses": losses, "caps": caps,
                   "d2h_bytes": d2h, "launches": counts.get(move, 0),
                   "kernel_checks": checks, "captured_bytes": captured,
                   "profiled_read_consume": profiled},
        "dense": {"impl": dense_impl, "read_ms": dense_read_ms,
                  "consume_ms": dense_ms, "cap": dense_cap,
                  "loss": float(dense_loss)},
        "host_staged": {"read_ms": host_read_ms, "consume_ms": host_ms,
                        "loss": float(host_loss), "h2d_bytes": h2d},
        "first_loss_rel_diff": rel})
    return out


# -- the five-axis MoE transformer (models/transformer.py) -------------------
# Switch-Base-8's published widths (Fedus et al. 2021, arXiv:2101.03961;
# google/switch-base-8), one stack's depth, Switch's 512-token inputs
TF_VOCAB = 32128
TF_D = 768
TF_HEADS = 12
TF_HEAD_DIM = 64
TF_FF = 3072
TF_EXPERTS = 8
TF_LAYERS = 12
TF_SEQ = 512
TF_BATCH = 64              # sequences a step: 32,768 tokens
TF_MICROBATCHES = 2
TF_CF = 2.0
TF_STEPS = 5
# moe_train's lr 1e-3 raised the loss over five steps at this depth and
# batch, under ring attention (no kernel) as under Ulysses (PERF.md
# section 7); 1e-4 lowers it at every step
TF_LR = 1e-4
TF_MESH2_LAYERS = 2
# kernels against their plain versions (and a grid against the trivial
# one) in float32: a routing decision may differ only at a top-2 logit
# gap below this, and the logits hold to 2e-4 of max|logits|
# (tests/test_transformer.py's tolerance) where no such decision reaches
TF_GAP = 1e-5
TF_LOGIT_TOL = 2e-4
# bfloat16 grid against the trivial grid, routed alike (the trivial
# grid's decisions replayed). One rounding of every x_d moves a logit
# sum_d x_d r_d by at most 2**-8 (bf16's unit roundoff) x sum_d |x_d r_d|,
# about 0.07 at d_model 768 (unit-RMS x, router entries of 768**-0.5), so
# a top-2 pair can move apart by 0.14 in each run: a decision of the
# grid's own may differ from the trivial grid's below a gap of 2**-2. The
# logits of the replayed routing, which differ by the roundings of the tp
# partial sums, hold within 2e-2 of max|logits| (five bf16 steps of the
# largest logit; tests/test_torch_transformer.py's BF16_TOL)
TF_BF16_GAP = 2.0 ** -2
TF_BF16_TOL = 2e-2
FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def transformer_config(layers: int, attn: str, dtype: str = "float32"):
    from sparkucx_tpu_torch.models import transformer as tt
    return tt.TransformerConfig(
        vocab=TF_VOCAB, d_model=TF_D, num_heads=TF_HEADS,
        head_dim=TF_HEAD_DIM, d_ff=TF_FF, num_layers=layers,
        num_experts=TF_EXPERTS, seq_len=TF_SEQ,
        microbatches=TF_MICROBATCHES, capacity_factor=TF_CF, attn=attn,
        remat=True, compute_dtype=dtype)


def transformer_inputs(cfg, dev, seed: int):
    """(parameters, tokens, targets) on the card from ``seed``: tokens
    uniform over the vocabulary (no corpus is in the repository)."""
    import torch
    from sparkucx_tpu_torch.models import transformer as tt
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    params = tt.init_params(cfg, g, dev)
    toks = torch.randint(0, cfg.vocab, (TF_BATCH, TF_SEQ + 1), generator=g,
                         device=dev)
    return params, toks[:, :-1].contiguous(), toks[:, 1:].contiguous()


def transformer_routed_forward(params, tokens, mesh, cfg, impl=None,
                               replay=None) -> dict:
    """One forward without autograd that records every MoE layer's
    routing: ``{"logits" [B, T, V], "experts" [L, B, T] (the expert each
    (layer, token) chose), "gaps" [L, B, T] (its top-2 logit gap),
    "replayed"}``. ``impl`` replaces the Ulysses path's flash impl for the
    call (``"interpret"``: the kernels' plain versions); ``replay``
    (another run's ``experts``) routes every token as that run did, while
    ``experts`` still records this run's own choices."""
    import torch
    from sparkucx_tpu_torch.models import transformer as tt
    g = tt.mesh_axis_sizes(mesh)
    B, T = tokens.shape
    L, M = cfg.num_layers, cfg.microbatches
    dp, sp, ep = g["dp"], g["sp"], g["ep"]
    mb, t, Ls = B // (dp * ep * M), T // sp, L // g["pp"]
    shape = (L, dp * ep, M, mb, T)
    experts = torch.empty(shape, dtype=torch.long, device=tokens.device)
    gaps = torch.empty(shape, dtype=torch.float32, device=tokens.device)
    if replay is not None:
        replay = replay.reshape(shape)
    calls = []
    route0, impl0 = tt._route, tt.ULYSSES_IMPL

    def to_global(a):        # [sp*dp, ep, mb*t] -> [dp*ep, mb, T]
        return a.reshape(sp, dp, ep, mb, t).movedim(0, 3).reshape(
            dp * ep, mb, T)

    def to_shards(a):        # the inverse
        return a.reshape(dp, ep, mb, sp, t).movedim(3, 0).reshape(
            sp * dp, ep, mb * t)

    def route(x, router, cfg_):
        logits, expert, gate = route0(x, router, cfg_)
        c = len(calls)
        calls.append(c)
        layer, m = (c // (M * Ls)) * Ls + c % Ls, (c // Ls) % M
        top2 = torch.topk(logits, 2, dim=-1).values
        experts[layer, :, m] = to_global(expert)
        gaps[layer, :, m] = to_global(top2[..., 0] - top2[..., 1])
        if replay is not None:
            expert = to_shards(replay[layer, :, m])
            gate = torch.gather(torch.softmax(logits, dim=-1), -1,
                                expert[..., None])[..., 0].to(gate.dtype)
        return logits, expert, gate

    tt._route = route
    if impl is not None:
        tt.ULYSSES_IMPL = impl
    try:
        with torch.no_grad():
            logits = tt.forward(params, tokens, mesh, cfg)
    finally:
        tt._route, tt.ULYSSES_IMPL = route0, impl0
    if len(calls) != L * M:
        raise AssertionError(f"{len(calls)} routing calls, want {L * M}")
    return {"logits": logits, "experts": experts.reshape(L, B, T),
            "gaps": gaps.reshape(L, B, T), "replayed": replay is not None}


def transformer_routing_check(got, want, gap_limit: float, rel: float,
                              what: str) -> dict:
    """Hold ``got`` against ``want`` (two :func:`transformer_routed_forward`
    results on the same parameters and tokens). Layer by layer, a
    (layer, token) decision that differs while no earlier differing
    decision reaches its position must have a top-2 logit gap (the larger
    of the two runs') below ``gap_limit``; unless ``got`` replayed
    ``want``'s routing, every position at or after a differing decision
    in its sequence (causal attention carries it there) leaves the logit
    check. The logits of the kept positions must be within ``rel`` of
    max|want's logits|. Returns the counts and errors."""
    import torch
    differ = got["experts"] != want["experts"]
    gap = torch.maximum(got["gaps"], want["gaps"])
    tainted = torch.zeros(differ.shape[1:], dtype=torch.bool,
                          device=differ.device)
    first, worst = 0, 0.0
    for layer in range(differ.shape[0]):
        new = differ[layer] & ~tainted
        if bool(new.any()):
            first += int(new.sum())
            worst = max(worst, float(gap[layer][new].max()))
        if not got["replayed"]:
            tainted |= torch.cummax(differ[layer].to(torch.int32),
                                    dim=-1).values.bool()
    keep = ~tainted
    scale = float(want["logits"].abs().max())
    err = (got["logits"] - want["logits"]).abs_().amax(dim=-1)
    max_err = float(err[keep].max()) if bool(keep.any()) else 0.0
    out = {"decisions": int(differ.numel()),
           "disagree": int(differ.sum()), "disagree_first": first,
           "max_disagree_gap": worst, "gap_limit": gap_limit,
           "kept_positions": int(keep.sum()), "positions": int(keep.numel()),
           "max_abs_err": max_err, "max_abs_logit": scale,
           "tolerance": rel * scale}
    finite = bool(torch.isfinite(got["logits"]).all())
    if worst >= gap_limit or max_err > rel * scale or not finite:
        raise AssertionError(f"{what}: {out}, logits finite {finite}")
    return out


def one_hot_flops(cfg, mesh, tokens: int) -> dict:
    """FLOPs of one forward's one-hot expert products (w1 and w2): every
    received row through every local expert, ``L * M * 2 * (2 * G * ep *
    e_local * cap * D * F)`` with ``G * ep`` shards of ``n`` rows a
    microbatch and ``cap = max(8, n * capacity_factor)``; every token is
    received by one shard, so ``tokens`` rows are real and the rest of
    each expert's batch multiplies zero rows."""
    from sparkucx_tpu_torch.models import transformer as tt
    g = tt.mesh_axis_sizes(mesh)
    shards = g["dp"] * g["sp"] * g["ep"]
    n = tokens // (shards * cfg.microbatches)
    e_local = cfg.num_experts // g["ep"]
    cap = max(8, int(n * cfg.capacity_factor))
    per_row = 2 * 2 * cfg.d_model * cfg.d_ff
    total = cfg.num_layers * cfg.microbatches * shards * e_local * cap \
        * per_row
    useful = cfg.num_layers * tokens * per_row
    return {"rows_per_shard": n, "recv_capacity": cap, "e_local": e_local,
            "forward_flops": total, "useful_flops": useful,
            "zero_row_share": 1 - useful / total}


def transformer_train_phase(dev) -> dict:
    """The slice at full width: Switch-Base-8's widths at 12 layers,
    attn="ulysses", remat on, float32, 64 sequences of 512 on
    ``make_mesh(8)`` (dp 1, pp 2, sp 2, tp 1, ep 2). (a) The forward
    through the flash kernels against the same forward through their
    plain versions; (b) five Adam steps, losses finite and falling; (c)
    the flash launches of each step; (d) the first captured flash_dq and
    flash_dkv launch of a step against the plain backward; then the walls,
    the peak device bytes, one profiled step and the one-hot products'
    FLOPs."""
    import torch
    from sparkucx_tpu_torch import backend
    from sparkucx_tpu_torch.models import transformer as tt
    from sparkucx_tpu_torch.ops import flash_attention as tfa
    cfg = transformer_config(TF_LAYERS, "ulysses")
    mesh = tt.make_mesh(8)
    g = tt.mesh_axis_sizes(mesh)
    L, M = cfg.num_layers, cfg.microbatches
    params0, x, y = transformer_inputs(cfg, dev, SEED + 50)
    out = {"grid": g, "layers": L, "d_model": TF_D, "heads": TF_HEADS,
           "head_dim": TF_HEAD_DIM, "d_ff": TF_FF, "experts": TF_EXPERTS,
           "vocab": TF_VOCAB, "sequences": TF_BATCH, "seq_len": TF_SEQ,
           "microbatches": M, "capacity_factor": TF_CF, "remat": True,
           "dtype": "float32", "attn": "ulysses",
           # [dp*ep*mb*H, T, Dh]: every shard's rows and heads in one call
           "flash_shape": [TF_BATCH // M * TF_HEADS, TF_SEQ, TF_HEAD_DIM]}
    # (a) kernels against their plain versions, routing and logits
    backend.reset_launch_counts()
    kern, fwd_ms = _timed(lambda: transformer_routed_forward(
        params0, x, mesh, cfg))
    fwd_counts = backend.launch_counts()
    plain = transformer_routed_forward(params0, x, mesh, cfg,
                                       impl="interpret")
    out["forward_vs_plain"] = transformer_routing_check(
        kern, plain, TF_GAP, TF_LOGIT_TOL, "transformer_train forward")
    del kern, plain
    if {k: fwd_counts.get(k, 0) for k in FLASH_KERNELS} != {
            "flash_fwd": L * M, "flash_dq": 0, "flash_dkv": 0}:
        raise AssertionError(f"transformer_train forward: launches "
                             f"{fwd_counts}, want flash_fwd {L * M}")
    with torch.no_grad():
        out["forward_ms"] = [_timed(lambda: tt.forward(
            params0, x, mesh, cfg))[1] for _ in range(2)]
    out["routed_forward_ms"] = fwd_ms
    # (b), (c): five Adam steps; (d) the first dq and dk/dv launch copied
    init, step = tt.make_train_step(mesh, cfg, lr=TF_LR, device=dev)
    params, opt = init(params0)
    captured = {}
    saved = [(name, getattr(tfa, name)) for name in
             ("flash_dq_kernel", "flash_dkv_kernel")]

    def capturing(name, orig):
        def launch(*args):
            got = orig(*args)
            if name not in captured:
                captured[name] = (_card_copy(args), _card_copy(got))
            return got
        return launch

    for name, orig in saved:
        setattr(tfa, name, capturing(name, orig))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        backend.reset_launch_counts()
        losses, walls = [], []
        for _ in range(TF_STEPS):
            (params, opt, loss), ms = _timed(lambda: step(params, opt, x, y))
            losses.append(float(loss))
            walls.append(ms)
        counts = backend.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        for name, orig in saved:
            setattr(tfa, name, orig)
    # remat: the forward, then each layer's recompute in backward
    per_step = {"flash_fwd": 2 * L * M, "flash_dq": L * M,
                "flash_dkv": L * M}
    if {k: counts.get(k, 0) for k in FLASH_KERNELS} != {
            k: n * TF_STEPS for k, n in per_step.items()}:
        raise AssertionError(f"transformer_train: flash launches {counts} "
                             f"in {TF_STEPS} steps, want {per_step} a step")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"transformer_train: losses {losses}")
    # (d) the captured backward launches against the plain versions
    (q, k, v, gg, lse, delta, causal, scale), kdq = captured["flash_dq_kernel"]
    kdk, kdv = captured["flash_dkv_kernel"][1]
    pdq = tfa.flash_dq_plain(q, k, v, gg, lse, delta, causal, scale)
    pdk, pdv = tfa.flash_dkv_plain(q, k, v, gg, lse, delta, causal, scale)
    torch.cuda.synchronize()
    # grad_tol's 1e-5 floor is set for unit cotangents; this one is the
    # loss's (mean over 32,768 tokens), so the floor scales with it. Both
    # versions are linear in (dO, delta): at a cotangent scaled by a power
    # of two their outputs scale exactly, so this is grad_tol at unit scale
    c = 2.0 ** round(math.log2(float(gg.abs().max())))
    out["captured_backward"] = {
        "shape": list(q.shape), "cotangent_scale": c,
        **{name: {"max_abs_err": flash_close(
            got, want, grad_tol(want / c) * c, f"transformer {name}"),
            "max_abs": float(want.abs().max())}
           for name, got, want in (("dq", kdq, pdq), ("dk", kdk, pdk),
                                   ("dv", kdv, pdv))},
        "tolerance": "grad_tol at the cotangent's scale c: "
                     "1e-3*max|g| + 1e-5*c"}
    if list(q.shape) != out["flash_shape"]:
        raise AssertionError(f"transformer_train: flash at {list(q.shape)}"
                             f", want {out['flash_shape']}")
    del captured, q, k, v, gg, lse, delta, kdq, kdk, kdv, pdq, pdk, pdv
    # one more step under device-activity tracing
    with device_profile(cpu=False) as prof:
        _, prof_ms = _timed(lambda: step(params, opt, x, y))
    flash_ms = {name: traced_kernel_ms(prof, name) for name in FLASH_KERNELS}
    out.update({
        "losses": losses, "step_walls_ms": walls,
        "step_ms": float(np.median(walls)), "peak_device_bytes": peak,
        "launches_per_step": per_step, "launches": counts,
        "one_hot": one_hot_flops(cfg, mesh, TF_BATCH * TF_SEQ),
        "profiled_step": {
            "wall_ms": prof_ms, **device_busy(prof, prof_ms),
            "flash_device_ms": {n: {"launches": len(v), "sum_ms": sum(v)}
                                for n, v in flash_ms.items()}},
        "card": card_line()})
    del params, opt, init, step, params0
    return out


def transformer_mesh2_phase(dev) -> dict:
    """Switch-Base-8's widths at 2 layers on ``make_mesh(8, order=("ep",
    "tp"))`` (dp 2, tp 2, ep 2) with ring attention, in float32 and in
    bfloat16 (the two variants of the reference's dryrun): one forward
    held against the trivial grid's, then one training step (loss finite,
    master parameters float32)."""
    import torch
    from sparkucx_tpu_torch.models import transformer as tt
    mesh = tt.make_mesh(8, order=("ep", "tp"))
    trivial = tt.ShardGrid()
    out = {"grid": tt.mesh_axis_sizes(mesh), "layers": TF_MESH2_LAYERS,
           "attn": "ring"}
    params0 = x = y = None
    for dtype in ("float32", "bfloat16"):
        cfg = transformer_config(TF_MESH2_LAYERS, "ring", dtype)
        if params0 is None:
            params0, x, y = transformer_inputs(cfg, dev, SEED + 51)
        want, want_ms = _timed(lambda: transformer_routed_forward(
            params0, x, trivial, cfg))
        bf16 = dtype == "bfloat16"
        got, got_ms = _timed(lambda: transformer_routed_forward(
            params0, x, mesh, cfg,
            replay=want["experts"] if bf16 else None))
        check = transformer_routing_check(
            got, want, TF_BF16_GAP if bf16 else TF_GAP,
            TF_BF16_TOL if bf16 else TF_LOGIT_TOL,
            f"transformer_mesh2 {dtype}")
        del got, want
        init, step = tt.make_train_step(mesh, cfg, lr=TF_LR, device=dev)
        params, opt = init(params0)
        (params, opt, loss), step_ms = _timed(lambda: step(params, opt, x,
                                                           y))
        dtypes = {k: str(v.dtype) for k, v in params.items()}
        if not np.isfinite(float(loss)) or set(dtypes.values()) != {
                "torch.float32"}:
            raise AssertionError(f"transformer_mesh2 {dtype}: loss "
                                 f"{float(loss)}, master dtypes {dtypes}")
        out[dtype] = {"forward_vs_trivial": check,
                      "trivial_forward_ms": want_ms,
                      "grid_forward_ms": got_ms, "step_ms": step_ms,
                      "loss": float(loss), "master_dtype": "float32"}
        del params, opt, init, step
    return out


class PlaneTally:
    """While installed, counts over every node's metrics the spills
    (``shuffle.spill.count`` / ``.bytes``) and the reads whose admission
    waited (``shuffle.admit.wait_ms`` observations above 0);
    :meth:`cut` files what was counted since the previous cut under a
    phase's name."""

    KEYS = ("spill_count", "spill_bytes", "deferred_reads")

    def __init__(self):
        self.totals = dict.fromkeys(self.KEYS, 0.0)
        self.phases = {}
        self._mark = dict(self.totals)

    def install(self) -> "PlaneTally":
        from sparkucx_tpu_torch.utils import metrics as mt
        self._saved = inc, observe = mt.Metrics.inc, mt.Metrics.observe
        totals = self.totals

        def counting_inc(m, name, value=1.0):
            if name == mt.C_SPILL_COUNT:
                totals["spill_count"] += value
            elif name == mt.C_SPILL_BYTES:
                totals["spill_bytes"] += value
            inc(m, name, value)

        def counting_observe(m, name, value):
            if name == mt.H_ADMIT_WAIT and value > 0:
                totals["deferred_reads"] += 1
            observe(m, name, value)

        mt.Metrics.inc, mt.Metrics.observe = counting_inc, counting_observe
        return self

    def uninstall(self) -> None:
        from sparkucx_tpu_torch.utils import metrics as mt
        mt.Metrics.inc, mt.Metrics.observe = self._saved

    def cut(self, phase: str) -> None:
        self.phases[phase] = {k: self.totals[k] - self._mark[k]
                              for k in self.KEYS}
        self._mark = dict(self.totals)


def spill_phase(dev, keys, values, spill_dir: str) -> dict:
    """main's records written under ``spill.threshold=4m`` in chunks of
    8,192 rows, then read plain on the default conf (the segment move)
    and held against the oracle; a second read beside it."""
    from sparkucx_tpu_torch import connect
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME
    from sparkucx_tpu_torch.utils.metrics import C_SPILL_BYTES, C_SPILL_COUNT
    conf = {"spark.shuffle.tpu.spill.threshold": SPILL_THRESHOLD,
            "spark.shuffle.tpu.spill.dir": spill_dir}
    n = keys.shape[0]
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        t = time.perf_counter()
        h = svc.register_shuffle(40, MAPS, PARTITIONS)
        per = -(-n // MAPS)
        for m in range(MAPS):
            lo, hi = m * per, min((m + 1) * per, n)
            w = svc.writer(h, m)
            for c in range(lo, hi, SPILL_CHUNK_ROWS):
                e = min(c + SPILL_CHUNK_ROWS, hi)
                w.write(keys[c:e], values[c:e])
            w.commit(PARTITIONS)
        write_s = time.perf_counter() - t
        mets = svc.node.metrics
        spill_bytes = int(mets.get(C_SPILL_BYTES))
        spill_count = int(mets.get(C_SPILL_COUNT))
        pool_after_write = svc.node.pool.stats()
        parts, stats = device_read(svc, h, dev, (KERNEL_NAME,))
        rep = svc.report(40)
        t = time.perf_counter()
        check_against_oracle(parts, keys, values, PARTITIONS)
        oracle_s = time.perf_counter() - t
        del parts
        parts, read2_ms, views2_ms = drive_read(svc, h)
        del parts
        rep2 = svc.report(40)
        svc.unregister_shuffle(40)
        left = os.listdir(spill_dir)
    if spill_bytes != n * RECORD_BYTES or spill_count < 3 * MAPS:
        raise AssertionError(f"spill: {spill_bytes} B in {spill_count} "
                             f"spills, want {n * RECORD_BYTES} B in about "
                             f"{4 * MAPS}")
    if pool_after_write["in_use_bytes"] or left:
        raise AssertionError(f"spill: pool {pool_after_write} after the "
                             f"writes, files left {left[:4]}")
    return {"phase": "spill", "records": n, "maps": MAPS,
            "threshold": SPILL_THRESHOLD, "chunk_rows": SPILL_CHUNK_ROWS,
            "write_s": write_s, "spill_bytes": spill_bytes,
            "spill_count": spill_count,
            "pool_after_write": pool_after_write, "impl": rep.impl,
            **stats, "pack_ms": rep.pack_ms, "group_ms": rep.group_ms,
            "read2_ms": read2_ms, "views2_ms": views2_ms,
            "read2_pack_ms": rep2.pack_ms, "oracle_s": oracle_s,
            "ok": True}


def _key_checksum(carry, rows, totals):
    """Consumer of one device-sink ordered read: (rows delivered, the
    int64 sum of their keys, whether a shard's valid keys ever
    decrease)."""
    import torch
    cap = rows.shape[1]
    valid = torch.arange(cap, device=rows.device)[None, :] < totals[:, None]
    k = rows[:, :, :2].contiguous().view(torch.int64)[..., 0]
    out = (totals.sum(), torch.where(valid, k, 0).sum(),
           ((k[:, 1:] < k[:, :-1]) & valid[:, 1:]).any())
    return out if carry is None else tuple(a + b for a, b in zip(carry, out))


def one_read_footprint(rep, width: int) -> int:
    """``ShuffleManager._exchange_footprint`` of a single-shot read from
    its report's plan bucket: the pinned pack buffer plus the device
    send and receive buffers."""
    from types import SimpleNamespace

    from sparkucx_tpu_torch.shuffle.manager import ShuffleManager
    cap_in, cap_out = rep.plan_bucket
    plan = SimpleNamespace(cap_in=cap_in, cap_out=cap_out, num_shards=SHARDS)
    return ShuffleManager._exchange_footprint(plan, width,
                                              SHARDS * cap_in * width * 4)


def admission_pair(dev, keys, values, bounds, cap: int) -> dict:
    """Submit A, submit B, consume A, then B's result and its consume:
    two device-sink ``ordered=True`` reads of main's shuffle under main's
    conf (the segment move) and ``a2a.maxBytesInFlight=cap`` (0: no cap).
    Returns the reservations, B's wait, the device peak over the pair and
    the segment move's launches."""
    import torch
    from sparkucx_tpu_torch import backend, connect
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME
    conf = {"spark.shuffle.tpu.a2a.impl": "pallas",       # main's conf
            "spark.shuffle.tpu.a2a.maxBytesInFlight": str(cap)}
    want_sum = int(keys.sum())
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        m = svc.manager
        h = write_maps(svc, 41, keys, values, MAPS, "range", bounds)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        backend.reset_launch_counts()
        t0 = time.perf_counter()
        pa = svc.submit(h, ordered=True, sink="device")
        rep_a, held_a = svc.report(41), m._inflight_bytes
        pb = svc.submit(h, ordered=True, sink="device")
        rep_b, held_ab = svc.report(41), m._inflight_bytes
        got = [pa.result().consume(_key_checksum)]
        held_after_a = m._inflight_bytes
        got.append(pb.result().consume(_key_checksum))
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev)
        launches = counted(KERNEL_NAME)
        held_end = m._inflight_bytes
        svc.unregister_shuffle(41)
    for tag, (nrows, ksum, unsorted) in zip("AB", got):
        if (int(nrows), int(ksum), bool(unsorted)) != (keys.shape[0],
                                                       want_sum, False):
            raise AssertionError(f"admission read {tag}: {int(nrows)} rows, "
                                 f"key sum {int(ksum)} (want {want_sum}), "
                                 f"unsorted {bool(unsorted)}")
    width = RECORD_WORDS
    return {"cap": cap, "impl": rep_a.impl,
            "footprint": [one_read_footprint(r, width)
                          for r in (rep_a, rep_b)],
            "reserved_after_submit_a": held_a,
            "reserved_after_submit_b": held_ab,
            "reserved_after_consume_a": held_after_a,
            "reserved_at_end": held_end,
            "b_deferred": bool(cap) and held_ab == held_a,
            "admit_wait_ms": [rep_a.admit_wait_ms, rep_b.admit_wait_ms],
            "pair_wall_ms": wall_ms, "peak_device_bytes": peak,
            "launches": {KERNEL_NAME: launches}}


def admission_phase(dev, keys, values) -> dict:
    """The pair with no cap, then under a cap of one read's footprint (B
    must defer until A is consumed, and the pair's device peak must fall
    below the uncapped pair's); then waved_ordered's device-sink read
    under that cap: its reservation beside its measured peak."""
    import torch
    from sparkucx_tpu_torch import connect
    bounds = terasort_bounds(keys)
    free = admission_pair(dev, keys, values, bounds, 0)
    cap = free["footprint"][0]
    capped = admission_pair(dev, keys, values, bounds, cap)
    if free["reserved_after_submit_b"] or free["admit_wait_ms"] != [0, 0]:
        raise AssertionError(f"uncapped pair reserved or waited: {free}")
    if any(list(p["launches"].values()) != [2] for p in (free, capped)):
        raise AssertionError("admission: each pair must launch the segment "
                             "move twice")
    if not (capped["reserved_after_submit_a"] == cap
            and capped["b_deferred"]
            and capped["reserved_after_consume_a"] == 0
            and capped["admit_wait_ms"][1] > 0
            and capped["reserved_at_end"] == 0):
        raise AssertionError(f"capped pair: B did not defer behind A and "
                             f"release: {capped}")
    if not capped["peak_device_bytes"] < free["peak_device_bytes"]:
        raise AssertionError(f"capped pair peak {capped['peak_device_bytes']}"
                             f" not below {free['peak_device_bytes']}")
    wconf = {**WAVE_CONF, "spark.shuffle.tpu.a2a.maxBytesInFlight": str(cap)}
    with connect(wconf, num_shards=SHARDS, use_env=False) as svc:
        h = write_maps(svc, 42, keys, values, MAPS, "range", bounds)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        res = svc.read(h, ordered=True, sink="device")
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        reserved = svc.manager._inflight_bytes
        rep = svc.report(42)
        nrows, ksum, unsorted = res.consume(_key_checksum)
        released = svc.manager._inflight_bytes == 0
        svc.unregister_shuffle(42)
    if not (rep.waves == 5 and reserved > 0 and released
            and int(nrows) == keys.shape[0] and int(ksum) == int(keys.sum())
            and not bool(unsorted)):
        raise AssertionError(f"waved admission: waves {rep.waves}, reserved "
                             f"{reserved}, released {released}")
    width = RECORD_WORDS
    depth = int(WAVE_CONF["spark.shuffle.tpu.a2a.waveDepth"])
    cap_in, cap_out = rep.plan_bucket
    stage = depth * SHARDS * cap_in * width * 4
    return {"phase": "admission", "records": int(keys.shape[0]),
            "gap_bytes": free["peak_device_bytes"]
            - capped["peak_device_bytes"],
            "capped": capped, "uncapped": free,
            "waved_ordered": {
                "cap": cap, "waves": rep.waves, "plan_bucket": rep.plan_bucket,
                "reserved": reserved, "reserved_stage_bytes": stage,
                "reserved_device_bytes": reserved - stage,
                "peak_device_bytes": peak,
                "device_term_over_peak": (reserved - stage) / peak,
                "admit_wait_ms": rep.admit_wait_ms, "merge_ms": rep.merge_ms},
            "ok": True}


def pipelines_phase(dev, spill_root: str) -> dict:
    """Each external-memory pipeline at its cell's size under the conf
    ``run_workload`` derives from its budget (dataset bytes / 10), on
    its own ``connect(num_shards=8)``, under device-activity tracing.
    Launch rule: the waved reads run ``dense``, so no segment move; a
    combine read launches the segment reduce once per wave attempt and,
    on the device sink, the merge and the segment reduce once per fold
    step (waves - 1). The first and the last launch of each kernel are
    held against the plain versions (:class:`KernelCapture`)."""
    import importlib

    import torch
    from sparkucx_tpu_torch import backend, connect
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME as move
    from sparkucx_tpu_torch.ops.segmented import KERNEL_NAME as reduce
    from sparkucx_tpu_torch.ops.segmented import MERGE_KERNEL_NAME as merge
    from sparkucx_tpu_torch.workloads import workload_conf_overrides
    out = {}
    for name, module, fn, budget, kw in PIPELINE_RUNS:
        run = getattr(importlib.import_module(
            f"sparkucx_tpu_torch.workloads.{module}"), fn)
        spill_dir = os.path.join(spill_root, name)
        conf = {**workload_conf_overrides(budget, num_shards=SHARDS),
                "spark.shuffle.tpu.spill.dir": spill_dir}
        extra = {"run_dir": os.path.join(spill_root, "runs")} \
            if module == "terasort" else {}
        pinned_before = \
            torch.cuda.host_memory_stats()["allocated_bytes.current"]
        with connect(conf, num_shards=SHARDS, use_env=False) as svc:
            torch.cuda.reset_peak_memory_stats(dev)
            with ReadTally(svc.manager) as tally, \
                    KernelCapture() as capture, \
                    device_profile(cpu=False) as prof:
                backend.reset_launch_counts()
                t0 = time.perf_counter()
                rep = run(svc.manager, budget_bytes=budget, **kw, **extra)
                torch.cuda.synchronize(dev)
                wall = time.perf_counter() - t0
                counts = backend.launch_counts()
            pool = svc.node.pool.stats()
            free_cap = svc.node.pool.max_free_bytes
            peak = torch.cuda.max_memory_allocated(dev)
        # page-locked bytes torch holds (in use or cached) before the node
        # and after its close: what the pipeline left pinned
        pinned = torch.cuda.host_memory_stats()["allocated_bytes.current"]
        captured = capture.nbytes()
        checks = capture.check(f"pipeline {name}")
        launches = {k: counts.get(k, 0) for k in (move, merge, reduce)}
        W = rep.waves
        device_fold = kw.get("sink") == "device"
        want = {move: 0, merge: 0, reduce: 0}
        if tally.combine_reads:
            want[reduce] = tally.combine_reads * (
                2 * W - 1 if device_fold else W) + tally.combine_retries
            want[merge] = tally.combine_reads * (W - 1) if device_fold else 0
        if launches != want:
            raise AssertionError(f"pipeline {name}: launches {launches}, "
                                 f"want {want} ({tally.reads} reads, "
                                 f"{W} waves, {tally.retries} retries)")
        if set(checks) != {k for k, v in launches.items() if v}:
            raise AssertionError(f"pipeline {name}: checked {checks}, "
                                 f"launched {launches}")
        if not (rep.oracle_ok and rep.spill_bytes > 0
                and rep.extra["forced_spills"] > 0
                and pool["in_use_bytes"] == 0 and W > 1
                and pool["free_bytes"] <= free_cap
                and rep.rows_in == kw["total_rows"]
                and rep.extra.get("d2h_bytes", 0) == 0):
            raise AssertionError(f"pipeline {name}: {rep.to_json(None)}; "
                                 f"pool {pool}")
        line = {"phase": "pipeline", "name": name, "args": kw,
                "budget_bytes": budget, "conf": conf,
                "report": rep.to_dict(), "wall_s": wall,
                "reads": tally.reads, "retries": tally.retries,
                "impls": sorted(tally.impls), "launches": launches,
                "kernel_checks": checks,
                "pool_peak_bytes": rep.pool_peak_bytes,
                "pool_peak_over_budget": rep.pool_peak_bytes / budget,
                "pool_after": pool, "pool_free_cap": free_cap,
                "pinned_before_bytes": pinned_before,
                "pinned_after_close_bytes": pinned,
                "peak_device_bytes": peak, "captured_bytes": captured,
                "rows_per_s": kw["total_rows"] / wall,
                **device_busy(prof, wall * 1e3)}
        print(json.dumps(line), flush=True)
        out[name] = line
    return out


# -- the two-tier topology plane (shuffle/topology.py) and io/dlpack ---------
HIER_CONF = {"spark.shuffle.tpu.mesh.numSlices": "2"}   # 2 slices x 4 shards
HIER_WAVE_ROWS = 262_144   # 1,310,720 staged rows per shard -> 5 waves
DLPACK_BYTES = 1 << 30


def tier_summary(rep) -> list:
    """The report's tier entries as the phase prints them."""
    return [{k: t[k] for k in ("tier", "impl", "payload_rows",
                               "payload_bytes", "wire_bytes", "pad_ratio",
                               "cross_exact", "ms", "bw_gbps")}
            for t in rep.tiers]


def hier_read(svc, h, dev, **read_kw) -> tuple:
    """One measured hierarchical read (launch counts and peak memory reset
    just before): the tiered path ran (both tiers on the report, dense,
    the headline wire the two-hop sum) and no hier read reached the
    segment move or the segment reduce. Returns (result, stats,
    report)."""
    import torch
    from sparkucx_tpu_torch import backend
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME as A2A
    from sparkucx_tpu_torch.ops.segmented import KERNEL_NAME as SEG
    torch.cuda.reset_peak_memory_stats(dev)
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    res = svc.read(h, **read_kw)
    torch.cuda.synchronize()
    read_ms = (time.perf_counter() - t0) * 1e3
    launches = backend.launch_counts()
    rep = svc.report(h.shuffle_id)
    if not (rep.hierarchical and rep.impl == "dense"
            and [t["tier"] for t in rep.tiers] == ["ici", "dcn"]
            and rep.wire_bytes == sum(t["wire_bytes"] for t in rep.tiers)):
        raise AssertionError(f"hier read: hierarchical={rep.hierarchical} "
                             f"impl={rep.impl} tiers={tier_summary(rep)}")
    if launches.get(A2A, 0) or launches.get(SEG, 0):
        raise AssertionError(f"a hier read launched {launches}")
    return res, {"read_ms": read_ms, "group_ms": rep.group_ms,
                 "pack_ms": rep.pack_ms, "dispatch_ms": rep.dispatch_ms,
                 "payload_bytes": rep.payload_bytes,
                 "wire_bytes": rep.wire_bytes, "wire": rep.wire,
                 "retries": rep.retries, "plan_bucket": rep.plan_bucket,
                 "tiers": tier_summary(rep),
                 "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
                 "launches": launches}, rep


def same_partitions(a, b, tag: str) -> None:
    """Two reads of one shuffle hold the same (key, value) rows in every
    partition (as multisets: row order within a partition may differ)."""
    for r in range(PARTITIONS):
        (ak, av), (bk, bv) = a[r], b[r]
        oa, ob = np.lexsort((av[:, 0], ak)), np.lexsort((bv[:, 0], bk))
        if not (np.array_equal(ak[oa], bk[ob])
                and np.array_equal(av[oa], bv[ob])):
            raise AssertionError(f"{tag}: partition {r} differs")


def check_two_steps(parts, raw_parts) -> dict:
    """int8 on both hops against the raw hier read of the same staging:
    the same keys in the same places, every value within two rounding
    steps (the first hop's amax/127, the second hop's of the rounded
    row, at most 1/127 larger)."""
    worst = 0.0
    for r in range(PARTITIONS):
        gk, gv = parts[r]
        rk, rv = raw_parts[r]
        if not np.array_equal(gk, rk):
            raise AssertionError(f"hier_int8 partition {r}: keys differ "
                                 f"from the raw hier read")
        step = np.abs(rv).max(axis=1, keepdims=True) / 127.0
        err = np.abs(gv.astype(np.float64) - rv)
        if (err > 2 * step * (1 + 1 / 127) * (1 + 1e-6)).any():
            raise AssertionError(f"hier_int8 partition {r}: a value is "
                                 f"more than two rounding steps off")
        worst = max(worst, float((err / np.maximum(step, 1e-30)).max()))
    return {"max_err_in_steps": worst}


def hier_phase(dev) -> dict:
    """The hierarchical read on a 2 x 4 slice grid under the default conf
    (``a2a.topology=auto`` -> hier, ``a2a.impl=auto`` -> dense) at main's
    sizes: plain (against the oracle and against the flat read of the
    same shuffle), ordered (TeraSort), combine, int8 (two quantize
    launches, the first and last held against ``quantize_plain``), waved
    ordered and a single-shot device sink."""
    from sparkucx_tpu_torch import connect
    from sparkucx_tpu_torch.ops import quant as tq
    out = {}
    keys, values = make_records(RECORDS, zipf=False, seed=SEED)
    with connect(HIER_CONF, num_shards=SHARDS, use_env=False) as svc:
        if not svc.manager.hierarchical:
            raise AssertionError("the 2-slice node did not resolve hier")
        wk, wv = make_records(1 << 16, zipf=False, seed=SEED + 1)
        warm_read(svc, 60, wk, wv)
        h = write_maps(svc, 61, keys, values, MAPS)
        res, st, rep = hier_read(svc, h, dev)
        t = time.perf_counter()
        parts = [res.partition(r) for r in range(PARTITIONS)]
        st["views_ms"] = (time.perf_counter() - t) * 1e3
        del res
        check_against_oracle(parts, keys, values, PARTITIONS)
        # hier_device: the same shuffle, single-shot, device sink
        dres, dst, drep = hier_read(svc, h, dev, sink="device")
        d2h_before = drep.d2h_bytes
        if not (drep.sink == "device" and d2h_before == 0):
            raise AssertionError(f"hier_device: sink={drep.sink} d2h "
                                 f"before host_view={d2h_before}")
        delivered = int(dres.device_totals().sum())
        t = time.perf_counter()
        hv = dres.host_view()
        dparts = [hv.partition(r) for r in range(PARTITIONS)]
        dst["views_ms"] = (time.perf_counter() - t) * 1e3
        del dres, hv
        check_against_oracle(dparts, keys, values, PARTITIONS)
        del dparts
        out["hier_device"] = {"phase": "hier_device", **dst,
                              "delivered_rows": delivered,
                              "d2h_before_host_view": d2h_before,
                              "d2h_after_host_view": drep.d2h_bytes,
                              "ok": True}
        svc.unregister_shuffle(61)
    flat_conf = {**HIER_CONF, "spark.shuffle.tpu.a2a.topology": "flat"}
    with connect(flat_conf, num_shards=SHARDS, use_env=False) as svc:
        h = write_maps(svc, 62, keys, values, MAPS)
        t = time.perf_counter()
        fparts, flat_ms, flat_views_ms = drive_read(svc, h)
        frep = svc.report(62)
        svc.unregister_shuffle(62)
    if frep.hierarchical or frep.tiers:
        raise AssertionError("a2a.topology=flat still ran the tiers")
    same_partitions(parts, fparts, "hier_plain vs flat")
    del parts, fparts
    out["hier_plain"] = {"phase": "hier_plain", "records": RECORDS,
                         "maps": MAPS, "partitions": PARTITIONS,
                         "grid": [2, SHARDS // 2], **st,
                         "flat": {"impl": frep.impl, "read_ms": flat_ms,
                                  "views_ms": flat_views_ms},
                         "ok": True}

    # -- hier_ordered: TeraSort proper; hier_waved: the same in 5 waves
    bounds = terasort_bounds(keys)
    pid = np.searchsorted(bounds, keys, side="right").astype(np.int64)
    for name, conf in (("hier_ordered", HIER_CONF),
                       ("hier_waved", {**HIER_CONF,
                                       "spark.shuffle.tpu.a2a.waveRows":
                                       str(HIER_WAVE_ROWS)})):
        with connect(conf, num_shards=SHARDS, use_env=False) as svc:
            h = write_maps(svc, 63, keys, values, MAPS, "range", bounds)
            res, st, rep = hier_read(svc, h, dev, ordered=True)
            t = time.perf_counter()
            parts = [res.partition(r) for r in range(PARTITIONS)]
            st["views_ms"] = (time.perf_counter() - t) * 1e3
            del res
            svc.unregister_shuffle(63)
        allk = np.concatenate([parts[r][0] for r in range(PARTITIONS)])
        if allk.size != keys.size or (np.diff(allk) < 0).any():
            raise AssertionError(f"{name}: partitions not globally sorted")
        del allk
        check_against_oracle(parts, keys, values, PARTITIONS, pid=pid)
        del parts
        if name == "hier_waved":
            if not (rep.waves == 5 and all(
                    e["ici_ms"] > 0 and e["dcn_ms"] > 0
                    for e in rep.wave_timeline)):
                raise AssertionError(f"hier_waved: waves={rep.waves} "
                                     f"timeline={rep.wave_timeline}")
            st.update({"waves": rep.waves,
                       "wave_timeline": rep.wave_timeline,
                       "wave_pack_hidden_ms": rep.wave_pack_hidden_ms})
        out[name] = {"phase": name, "records": RECORDS, **st, "ok": True}
    del keys, values

    # -- hier_combine: group-by-sum, finalized by combine_rows -------------
    ckeys, cvalues = make_combine_records(RECORDS, SEED + 4)
    with connect(HIER_CONF, num_shards=SHARDS, use_env=False) as svc:
        h = write_maps(svc, 64, ckeys, cvalues, MAPS)
        res, st, rep = hier_read(svc, h, dev, combine="sum")
        parts = [res.partition(r) for r in range(PARTITIONS)]
        del res
        svc.unregister_shuffle(64)
    uk, sums, _ = group_oracle(ckeys, cvalues)
    gk, gv = combined_rows(parts, PARTITIONS,
                           lambda k: hash_pid(k, PARTITIONS))
    want = (sums & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    if not (np.array_equal(gk, uk) and np.array_equal(gv, want)):
        raise AssertionError("hier_combine: keys or sums differ from the "
                             "oracle")
    del parts, ckeys, cvalues, gk, gv
    out["hier_combine"] = {"phase": "hier_combine", "records": RECORDS,
                           "rows_out": int(uk.size), **st, "ok": True}

    # -- hier_int8: the DLRM gradient rows on the int8 wire, both hops -----
    ikeys, grads = make_embedding_grads(INT8_RECORDS, SEED + 11)
    reads = {}
    for wire in ("raw", "int8"):
        conf = {**HIER_CONF, "spark.shuffle.tpu.a2a.wire": wire}
        with connect(conf, num_shards=SHARDS, use_env=False) as svc:
            h = write_maps(svc, 65, ikeys, grads, MAPS)
            with KernelCapture() as capture:
                res, st, rep = hier_read(svc, h, dev)
            parts = [res.partition(r) for r in range(PARTITIONS)]
            del res
            svc.unregister_shuffle(65)
        got = st["launches"].get(tq.KERNEL_NAME, 0)
        want_n = 2 + rep.retries if wire == "int8" else 0
        if got != want_n or rep.wire != wire:
            raise AssertionError(f"hier_int8 ({wire}): quantize launched "
                                 f"{got} times, expected {want_n}")
        if wire == "int8":
            # the first launch's copies count in the device peak above
            st["capture_bytes"] = capture.nbytes()
            st["kernel_checks"] = capture.check("hier_int8")
        reads[wire] = (parts, st)
    chk = check_two_steps(reads["int8"][0], reads["raw"][0])
    out["hier_int8"] = {"phase": "hier_int8", "records": INT8_RECORDS,
                        "value_lanes": EMB_DIM, "int8": reads["int8"][1],
                        "raw": reads["raw"][1], **chk, "ok": True}
    del reads, ikeys, grads
    return out


def dlpack_phase(dev) -> dict:
    """``io/dlpack.ingest_foreign`` of a 1 GB tensor on the card (zero
    copy) and of a 1 GB CPU tensor through the pinned pool onto the card
    (twice: a cold pool, then its block reused), with GB/s."""
    import torch
    from sparkucx_tpu_torch.io.dlpack import ingest_foreign
    from sparkucx_tpu_torch.runtime.node import (HostStagingPool,
                                                 _empty_host_cache)
    n = DLPACK_BYTES // 4
    on_card = torch.arange(n, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = ingest_foreign(on_card)
    zero_copy_ms = (time.perf_counter() - t) * 1e3
    if got.data_ptr() != on_card.data_ptr():
        raise AssertionError("ingest of a tensor on the card copied it")
    del got, on_card
    host = torch.arange(n, dtype=torch.float32)
    # a cold pool pins its block: none of torch's cached page-locked
    # blocks (the earlier phases freed some) may serve it
    _empty_host_cache()
    pool = HostStagingPool(pinned=True)
    walls = []
    for _ in range(2):
        t = time.perf_counter()
        got = ingest_foreign(host, device=dev, pool=pool)
        walls.append((time.perf_counter() - t) * 1e3)
        if not torch.equal(got.cpu(), host):
            raise AssertionError("pool ingest changed the bytes")
        del got
    if pool.stats()["in_use_bytes"]:
        raise AssertionError(f"pool ingest kept {pool.stats()} checked out")
    pool.close()
    return {"phase": "dlpack", "bytes": DLPACK_BYTES,
            "zero_copy_ms": zero_copy_ms,
            "pool_cold_ms": walls[0], "pool_warm_ms": walls[1],
            "pool_cold_gbps": DLPACK_BYTES / walls[0] / 1e6,
            "pool_warm_gbps": DLPACK_BYTES / walls[1] / 1e6, "ok": True}


# -- the multi-process read plane: two workers sharing the card ------------
DIST_PROCS = 2             # worker processes, 4 of the 8 shards each
DIST_WAVE_CONF = {"spark.shuffle.tpu.a2a.waveRows": str(WAVE_ROWS)}
DIST_FENCE_MS = 6000.0     # dist_peer_loss: failure.collectiveTimeoutMs
DIST_LOSS_ROWS = 16_384    # rows a map of the peer-loss drill (64 maps)
DIST_DEADLINE_S = 400.0    # each world's deadline
DIST_ENTER_MS = 2000.0     # dist_one_armed: failure.replayAgreeTimeoutMs
PFX = "spark.shuffle.tpu."
REPLAY_CONF = {PFX + "failure.policy": "replay"}


def partition_digest(keys, values) -> str:
    """An order-free digest of one partition's (key, value bytes) rows:
    the count and the wrapping sum of a 64-bit mix of every row."""
    k = np.asarray(keys).astype(np.uint64)
    w = np.ascontiguousarray(values).view(np.uint32).reshape(k.size, -1)
    h = k * np.uint64(0x9E3779B97F4A7C15)
    for j in range(w.shape[1]):
        h ^= w[:, j].astype(np.uint64) \
            * np.uint64(((0xBF58476D1CE4E5B9 * (j + 1)) | 1)
                        & 0xFFFFFFFFFFFFFFFF)
    h ^= h >> np.uint64(31)
    h *= np.uint64(0x94D049BB133111EB)
    h ^= h >> np.uint64(29)
    return f"{k.size}:{int(h.sum(dtype=np.uint64)):016x}"


def partition_digests(parts) -> dict:
    return {str(r): partition_digest(*kv) for r, kv in (
        parts.items() if isinstance(parts, dict) else enumerate(parts))}


class HopTally:
    """While installed, collects every ``CrossProcessHop`` made: the rows
    kept on this process, the bytes staged through the host each way
    (from the count matrix's splits) and the host-staged wall."""

    def __enter__(self) -> "HopTally":
        from sparkucx_tpu_torch.shuffle import distributed as tdist
        self.hops = []
        self._cls = tdist.CrossProcessHop
        self._init = self._cls.__init__

        def init(hop, *a, _init=self._init, **kw):
            _init(hop, *a, **kw)
            self.hops.append(hop)

        self._cls.__init__ = init
        return self

    def __exit__(self, *exc) -> None:
        self._cls.__init__ = self._init

    def totals(self) -> dict:
        keys = ("calls", "local_rows", "host_bytes_sent",
                "host_bytes_received", "host_ms", "d2h_ms", "all_to_all_ms",
                "h2d_ms")
        return {k: sum(h.stats[k] for h in self.hops) for k in keys}


def _own_maps(mgr, sid: int, keys, values, mine, partitioner="hash",
              bounds=None):
    """``write_maps``'s split over MAPS maps, committing only ``mine``."""
    h = mgr.register_shuffle(sid, MAPS, PARTITIONS, partitioner, bounds)
    per = -(-keys.shape[0] // MAPS)
    for m in mine:
        w = mgr.get_writer(h, m)
        w.write(keys[m * per:(m + 1) * per], values[m * per:(m + 1) * per])
        w.commit(PARTITIONS)
    return h


def dist_read(mgr, h, dev, **read_kw) -> tuple:
    """One measured distributed read by this worker (launch counts and the
    device peak reset just before, the workers met at a barrier first, so
    the wall does not hold one's wait for the other): (this worker's
    partitions, stats)."""
    import torch
    from sparkucx_tpu_torch import backend
    from sparkucx_tpu_torch.shuffle.distributed import allgather_blob
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    allgather_blob(np.zeros(1, dtype=np.int64), what="smoke barrier")
    backend.reset_launch_counts()
    with HopTally() as hops:
        t0 = time.perf_counter()
        res = mgr.read(h, **read_kw)
        if cuda:
            torch.cuda.synchronize(dev)
        read_ms = (time.perf_counter() - t0) * 1e3
    rep = mgr.report(h.shuffle_id)
    st = {"read_ms": read_ms, "pack_ms": rep.pack_ms,
          "group_ms": rep.group_ms, "retries": rep.retries,
          "impl": rep.impl, "sink": rep.sink, "waves": rep.waves,
          "distributed": rep.distributed, "d2h_before_views": rep.d2h_bytes,
          "payload_bytes": rep.payload_bytes, "wire_bytes": rep.wire_bytes,
          **hops.totals(), "launches": backend.launch_counts(),
          "peak_device_bytes": torch.cuda.max_memory_allocated(dev)
          if cuda else 0}
    t0 = time.perf_counter()
    view = res.host_view() if read_kw.get("sink") == "device" else res
    parts = dict(view.partitions())
    st["views_ms"] = (time.perf_counter() - t0) * 1e3
    st["partitions"] = sorted(parts)
    if rep.tiers:
        st["tiers"] = tier_summary(rep)
    return parts, st


def _dist_manager(ctx, conf: dict):
    from sparkucx_tpu_torch.config import ShuffleConf
    from sparkucx_tpu_torch.shuffle.manager import ShuffleManager
    return ShuffleManager(ctx.svc.node, ShuffleConf(conf, use_env=False))


def dist_worker(ctx) -> dict:
    """One worker of the ``distributed`` phase (``cluster.run_cluster``
    job): main's TeraSort records, combine's, int8_plain's gradient rows,
    the maps this process's shards own (``cluster.my_maps``), read as
    collectives; each worker checks its partitions against the oracle and
    holds the first and last launch of every kernel against its plain
    version (``KernelCapture``; on the card)."""
    from sparkucx_tpu_torch.cluster import my_maps
    svc = ctx.svc
    dev = svc.node.device
    cuda = dev.type == "cuda"
    n = int(ctx.args.get("records", RECORDS))
    n8 = int(ctx.args.get("int8_records", INT8_RECORDS))
    mine = my_maps(ctx, MAPS)
    out = {"rank": ctx.rank, "shards": svc.node.local_shard_ids,
           "maps": len(mine)}

    def captured(fn):
        if not cuda:
            return fn(), {}
        with KernelCapture() as cap:
            got = fn()
        return got, cap.check(f"worker {ctx.rank}")

    keys, values = make_records(n, zipf=False, seed=SEED)
    # warm the torch ops and the collectives (not counted, not timed)
    wk, wv = make_records(1 << 16, zipf=False, seed=SEED + 1)
    dist_read(svc.manager, _own_maps(svc.manager, 69, wk, wv, mine), dev)
    svc.unregister_shuffle(69)
    # dist_plain
    h = _own_maps(svc.manager, 70, keys, values, mine)
    parts, st = dist_read(svc.manager, h, dev)
    check_against_oracle(parts, keys, values, PARTITIONS)
    st["digests"] = partition_digests(parts)
    out["dist_plain"] = st
    del parts
    svc.unregister_shuffle(70)
    # dist_replay: an exchange fault on both workers under replay; one
    # replay.enter round, one budget unit each
    mr = _dist_manager(ctx, REPLAY_CONF)
    h = _own_maps(mr, 76, keys, values, mine)
    svc.node.faults.arm("exchange", fail_count=1)
    parts, st = dist_read(mr, h, dev)
    rep = mr.report(76)
    st.update(digests=partition_digests(parts), replays=rep.replays,
              replay_ms=rep.replay_ms, spent=mr._replay_counts.get(76, 0),
              exchange=list(svc.node.faults.stats()["exchange"]))
    out["dist_replay"] = st
    del parts
    mr.unregister_shuffle(76)
    mr.stop()
    # dist_full: main's maps at integrity.verify=full (the digest tables
    # all-gathered before the plan, every local partition verified after)
    mf = _dist_manager(ctx, {PFX + "integrity.verify": "full"})
    h = _own_maps(mf, 78, keys, values, mine)
    parts, st = dist_read(mf, h, dev)
    rep = mf.report(78)
    st.update(digests=partition_digests(parts), integrity=rep.integrity,
              integrity_bytes=rep.integrity_bytes)
    out["dist_full"] = st
    del parts
    mf.unregister_shuffle(78)
    mf.stop()
    # dist_hier: the slice boundary is the process boundary
    with ctx.connect({"spark.shuffle.tpu.mesh.numSlices":
                      str(ctx.nprocs)}) as hsvc:
        h = _own_maps(hsvc.manager, 71, keys, values, mine)
        parts, st = dist_read(hsvc.manager, h, dev)
        check_against_oracle(parts, keys, values, PARTITIONS)
        per = -(-n // MAPS)
        src = (np.arange(n) // per) % SHARDS
        dst = blocked_shard(hash_pid(keys, PARTITIONS))
        L = SHARDS // ctx.nprocs
        st["cross_rows_want"] = {
            "ici": int(((src % L) != (dst % L)).sum()),
            "dcn": int(((src // L) != (dst // L)).sum())}
        del parts, src, dst
        hsvc.unregister_shuffle(71)
    out["dist_hier"] = st
    # dist_waved_ordered: TeraSort in waves, device sink then host sink
    bounds = terasort_bounds(keys)
    pid = np.searchsorted(bounds, keys, side="right").astype(np.int64)
    mw = _dist_manager(ctx, DIST_WAVE_CONF)
    h = _own_maps(mw, 72, keys, values, mine, "range", bounds)
    for sink in ("device", "host"):
        (parts, st), checks = captured(
            lambda: dist_read(mw, h, dev, ordered=True, sink=sink))
        for r, (gk, _) in parts.items():
            if (np.diff(gk) < 0).any():
                raise AssertionError(f"dist_waved_ordered: partition {r} "
                                     f"is not sorted")
        check_against_oracle(parts, keys, values, PARTITIONS, pid=pid)
        st["kernel_checks"] = checks
        out[f"dist_waved_ordered_{sink}"] = st
        del parts
    mw.unregister_shuffle(72)
    mw.stop()
    # dist_decisions: the decision ledger on a two-slice node of its own
    # (history.dir shared by the workers)
    if "history_dir" in ctx.args:
        out["dist_decisions"] = dist_decisions(ctx, dev, keys, values, mine)
    del keys, values, pid
    # dist_combine: group-by-sum, the segment reduce in every worker
    ck, cv = make_combine_records(n, SEED + 4)
    h = _own_maps(svc.manager, 73, ck, cv, mine)
    (parts, st), checks = captured(
        lambda: dist_read(svc.manager, h, dev, combine="sum"))
    uk, sums, _ = group_oracle(ck, cv)
    want = dict(zip(uk.tolist(), (sums & 0xFFFFFFFF).astype(np.uint32)
                    .view(np.int32).tolist()))
    for r, (gk, gv) in parts.items():
        if (np.diff(gk) <= 0).any() or (hash_pid(gk, PARTITIONS) != r).any() \
                or [want[k] for k in gk.tolist()] != gv.tolist():
            raise AssertionError(f"dist_combine: partition {r} differs "
                                 f"from the oracle")
    st["rows_out"] = int(sum(k.size for k, _ in parts.values()))
    st["kernel_checks"] = checks
    out["dist_combine"] = st
    del parts, ck, cv, want
    svc.unregister_shuffle(73)
    # dist_int8: the DLRM gradient rows on the int8 wire, plain and combine
    ikeys, grads = make_embedding_grads(n8, SEED + 11)
    m8 = _dist_manager(ctx, {"spark.shuffle.tpu.a2a.wire": "int8"})
    h = _own_maps(m8, 74, ikeys, grads, mine)
    (parts, st), checks = captured(lambda: dist_read(m8, h, dev))
    ipid = hash_pid(ikeys, PARTITIONS)
    for r, (gk, _) in parts.items():
        if not np.array_equal(np.sort(gk), np.sort(ikeys[ipid == r])):
            raise AssertionError(f"dist_int8: partition {r} keys differ")
    st["digests"] = partition_digests(parts)
    st["kernel_checks"] = checks
    out["dist_int8"] = st
    del parts
    (parts, st), checks = captured(
        lambda: dist_read(m8, h, dev, combine="sum"))
    st["rows_out"] = int(sum(k.size for k, _ in parts.values()))
    st["kernel_checks"] = checks
    out["dist_int8_combine"] = st
    del parts, ikeys, grads, ipid
    m8.unregister_shuffle(74)
    m8.stop()
    # dist_async: six read_async reads of two tenants on 4 workers, each
    # batch's order agreed and each read under its turnstile ticket
    out["dist_async"] = dist_async(ctx, dev)
    # dist_fleet: the fleet view of the world's nodes, then a node pair
    # that persists the registry
    if "fleet_dir" in ctx.args:
        out["dist_fleet"] = dist_fleet(ctx)
    # dist_one_armed: a fault on worker 0 only, on a node of its own under
    # the fence (its groups are left broken: no teardown at exit)
    from sparkucx_tpu_torch.runtime.failures import TransientError
    from sparkucx_tpu_torch.shuffle.distributed import allgather_blob
    ctx.orphaned = True
    fenced = ctx.connect({
        **REPLAY_CONF,
        PFX + "failure.collectiveTimeoutMs": str(DIST_FENCE_MS),
        PFX + "failure.replayAgreeTimeoutMs": str(DIST_ENTER_MS)})
    lk, lv = make_records(MAPS * DIST_LOSS_ROWS, zipf=False, seed=SEED + 5)
    h = _own_maps(fenced.manager, 77, lk, lv, mine)
    if ctx.rank == 0:
        fenced.node.faults.arm("exchange", fail_count=1)
    allgather_blob(np.zeros(1, dtype=np.int64), what="smoke barrier")
    t0 = time.perf_counter()
    try:
        fenced.read(h)
        outcome = "completed"
    except (TransientError, RuntimeError) as e:
        outcome = f"{type(e).__name__}: {e}"[:300]
    out["dist_one_armed"] = {"outcome": outcome,
                             "wall_ms": (time.perf_counter() - t0) * 1e3,
                             "armed": ctx.rank == 0}
    return out


def dist_fleet(ctx) -> dict:
    """``dist_fleet`` in a worker, after the world's reads: this node's
    fleet registry (both workers' URLs, from the boot round); worker 0
    fetches ``/cluster/snapshot`` and ``/cluster/doctor`` from its node
    while worker 1 waits at a barrier; then a node pair on the same world
    boots under ``metrics.httpPort=0`` and the ``failure.ledgerDir`` both
    workers share (``args["fleet_dir"]``) and persists
    ``fleet_registry.json``."""
    from sparkucx_tpu_torch.shuffle.distributed import (
        allgather_blob, gather_fleet_registry)
    node = ctx.svc.node
    if node.live is None:
        raise AssertionError(f"dist_fleet (worker {ctx.rank}): the world's "
                             f"node has no live server")
    out = {"url": node.live.url,
           "registry": {str(p): u for p, u in node.fleet.peers().items()}}
    # what the boot round costs a node: the same allgather once more
    allgather_blob(np.zeros(1, dtype=np.int64), what="smoke barrier")
    t0 = time.perf_counter()
    gather_fleet_registry(node.fleet.entries.get(ctx.rank))
    out["registry_round_ms"] = (time.perf_counter() - t0) * 1e3
    if ctx.rank == 0:
        for route in ("snapshot", "doctor"):
            status, _, body, ms = scrape(f"{node.live.url}/cluster/{route}")
            if status != 200:
                raise AssertionError(f"dist_fleet: /cluster/{route} "
                                     f"answered {status}: {body[:300]}")
            doc = json.loads(body)
            meta = doc if route == "snapshot" else doc["fleet"]
            out[route] = {"ms": ms, **{k: meta[k] for k in (
                "expected", "missing_peers", "processes_answered")}}
        out["doctor"]["findings"] = [[f["rule"], f["grade"]]
                                     for f in doc["findings"]]
    allgather_blob(np.zeros(1, dtype=np.int64), what="smoke barrier")
    t0 = time.perf_counter()
    with ctx.connect({PFX + "metrics.httpPort": "0",
                      PFX + "failure.ledgerDir": ctx.args["fleet_dir"]}) \
            as pair:
        out["pair_boot_s"] = time.perf_counter() - t0
        out["pair_url"] = pair.node.live.url
        # both saved at boot before either stops its server
        allgather_blob(np.zeros(1, dtype=np.int64), what="smoke barrier")
    return out


def check_dist_fleet(results, fleet_dir: str) -> dict:
    """The parent's half of ``dist_fleet``: both registries name both
    workers' URLs, worker 0's scrape answered for both with no peer
    missing, and the persisted registry lists the pair's two URLs."""
    from sparkucx_tpu_torch.utils.collector import FleetRegistry
    st = [res["dist_fleet"] for res in results]
    urls = {str(i): s["url"] for i, s in enumerate(st)}
    if any(s["registry"] != urls for s in st):
        raise AssertionError(f"dist_fleet: registries "
                             f"{[s['registry'] for s in st]}, URLs {urls}")
    for route in ("snapshot", "doctor"):
        got = st[0][route]
        if not (got["processes_answered"] == 2
                and got["missing_peers"] == [] and got["expected"] == [0, 1]):
            raise AssertionError(f"dist_fleet: /cluster/{route} {got}")
    saved = {str(p): u for p, u in FleetRegistry.load(fleet_dir)
             .peers().items()}
    pair = {str(i): s["pair_url"] for i, s in enumerate(st)}
    if saved != pair:
        raise AssertionError(f"dist_fleet: fleet_registry.json {saved}, "
                             f"the pair's URLs {pair}")
    return {"phase": "dist_fleet", "card": card_line(), "urls": urls,
            "persisted": saved,
            "cluster_snapshot_ms": st[0]["snapshot"]["ms"],
            "cluster_doctor_ms": st[0]["doctor"]["ms"],
            "processes_answered": st[0]["snapshot"]["processes_answered"],
            "findings": st[0]["doctor"]["findings"],
            "registry_round_ms": [s["registry_round_ms"] for s in st],
            "pair_boot_s": [s["pair_boot_s"] for s in st], "ok": True}


def blocked_shard(pid) -> np.ndarray:
    """The shard each partition id lands on (the blocked map)."""
    from sparkucx_tpu_torch.ops.partition import blocked_partition_map
    return blocked_partition_map(PARTITIONS, SHARDS)[pid]


def _both(results, name: str, key: str):
    return [res[name][key] for res in results]


def dist_phase(dev, main_digests: dict) -> dict:
    """Two worker processes share the card, 4 of the 8 shards each
    (``cluster.run_cluster``, the nodes under ``failure.policy=replay``
    so that they make the replay group; ``auto`` -> ``dense``): the
    reads of :func:`dist_worker`, checked here across the workers (every
    partition on one worker, main's digests, the single-process int8
    read's bytes, exact DCN cross rows, the kernels' launches), then the
    peer-loss drill on a world of its own."""
    import gc

    import torch
    from sparkucx_tpu_torch import connect
    from sparkucx_tpu_torch.cluster import run_cluster
    from sparkucx_tpu_torch.ops import quant as tq
    from sparkucx_tpu_torch.ops import segmented as sg
    from sparkucx_tpu_torch.runtime.node import _empty_host_cache
    out = {}
    # the single-process int8 read whose bytes the workers' must equal
    ikeys, grads = make_embedding_grads(INT8_RECORDS, SEED + 11)
    with connect({"spark.shuffle.tpu.a2a.wire": "int8",
                  "spark.shuffle.tpu.a2a.impl": "dense"},
                 num_shards=SHARDS, use_env=False) as svc:
        res = svc.read(write_maps(svc, 80, ikeys, grads, MAPS))
        int8_digests = partition_digests(
            [res.partition(r) for r in range(PARTITIONS)])
        del res
    del ikeys, grads
    # the workers get the card's memory this process cached
    gc.collect()
    torch.cuda.empty_cache()
    _empty_host_cache()
    t = time.perf_counter()
    hist_dir = tempfile.mkdtemp(prefix="chip_smoke_decisions_")
    fleet_dir = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    try:
        run = run_cluster("chip_smoke:dist_worker", DIST_PROCS, SHARDS,
                          conf={**REPLAY_CONF,
                                PFX + "metrics.httpPort": "0"},
                          device=None, timeout_s=DIST_DEADLINE_S,
                          args={"history_dir": hist_dir,
                                "fleet_dir": fleet_dir})
        results = run.results
        out["dist_decisions"] = check_dist_decisions(results, hist_dir)
        out["dist_fleet"] = check_dist_fleet(results, fleet_dir)
    finally:
        shutil.rmtree(hist_dir, ignore_errors=True)
        shutil.rmtree(fleet_dir, ignore_errors=True)
    out["world"] = {"seconds": time.perf_counter() - t,
                    "attempts": run.attempts,
                    "shards": [r["shards"] for r in results],
                    "maps": [r["maps"] for r in results]}
    names = ("dist_plain", "dist_replay", "dist_full", "dist_hier",
             "dist_waved_ordered_device", "dist_waved_ordered_host",
             "dist_combine", "dist_int8", "dist_int8_combine")
    for name in names:
        parts = sorted(p for res in results
                       for p in res[name].pop("partitions"))
        if parts != list(range(PARTITIONS)):
            raise AssertionError(f"{name}: partitions not covered once")
        if not all(res[name]["distributed"] and res[name]["impl"] == "dense"
                   for res in results):
            raise AssertionError(f"{name}: not a dense distributed read")
    for name, want in (("dist_plain", main_digests),
                       ("dist_replay", main_digests),
                       ("dist_full", main_digests),
                       ("dist_int8", int8_digests)):
        got = {}
        for res in results:
            got.update(res[name].pop("digests"))
        if got != want:
            bad = sorted(int(r) for r in want if got.get(r) != want[r])
            raise AssertionError(f"{name}: partitions {bad[:8]} differ "
                                 f"from the single-process read's")
    for res in results:
        tiers = {t["tier"]: t for t in res["dist_hier"]["tiers"]}
        want = res["dist_hier"]["cross_rows_want"]
        if any(not tiers[k]["cross_exact"]
               or tiers[k]["payload_rows"] != want[k] for k in want):
            raise AssertionError(f"dist_hier: cross rows {tiers} against "
                                 f"{want}")
        dev_st = res["dist_waved_ordered_device"]
        if not (dev_st["waves"] == 5 and dev_st["d2h_before_views"] == 0
                and dev_st["sink"] == "device"):
            raise AssertionError(f"dist_waved_ordered_device: {dev_st}")
    for res in results:
        st = res["dist_full"]
        if st["integrity"] != "full":
            raise AssertionError(f"dist_full (worker {res['rank']}): "
                                 f"integrity {st['integrity']!r}")
    for res in results:
        st = res["dist_replay"]
        if not (st["replays"] == 1 and st["spent"] == 1
                and st["exchange"] == [2, 1] and st["replay_ms"] > 0):
            raise AssertionError(f"dist_replay (worker {res['rank']}): "
                                 f"{st}")
    armed, other = (res["dist_one_armed"] for res in results)
    if not (armed["outcome"].startswith("InjectedFault")
            and armed["wall_ms"] < DIST_FENCE_MS
            and (other["outcome"] == "completed"
                 or other["outcome"].startswith("PeerLostError"))
            and other["wall_ms"] < 2 * DIST_FENCE_MS):
        raise AssertionError(f"dist_one_armed: {armed} {other}")
    out["dist_one_armed"] = {"phase": "dist_one_armed",
                             "enter_ms": DIST_ENTER_MS,
                             "fence_ms": DIST_FENCE_MS,
                             "workers": [armed, other], "ok": True}
    a, b = (res["dist_async"] for res in results)
    flat = [s - 1 for batch in a["orders"] for s in batch]
    n_async = len(DIST_ASYNC_TENANTS)
    if not (a["orders"] == b["orders"] and a["ran"] == b["ran"] == flat
            and sorted(a["partitions"] + b["partitions"])
            == list(range(PARTITIONS))
            and all(x["async_workers"] == [4] * n_async
                    and x["tenants"] == list(DIST_ASYNC_TENANTS)
                    for x in (a, b))):
        raise AssertionError(f"dist_async: {a} {b}")
    out["dist_async"] = {"phase": "dist_async",
                         "tenants": list(DIST_ASYNC_TENANTS),
                         "agreed_orders": a["orders"], "ran": a["ran"],
                         "wall_ms": [a["wall_ms"], b["wall_ms"]],
                         "turnstile_wait_ms": [a["turnstile_wait_ms"],
                                               b["turnstile_wait_ms"]],
                         "workers": [a, b], "ok": True}
    launches = {}
    for kname, name, want in (
            (sg.MERGE_KERNEL_NAME, "dist_waved_ordered_device", 4),
            (sg.KERNEL_NAME, "dist_combine", None),
            (sg.WIRE_KERNEL_NAME, "dist_int8_combine", None),
            (tq.KERNEL_NAME, "dist_int8", None)):
        for res in results:
            st = res[name]
            got = st["launches"].get(kname, 0)
            exp = want if want is not None else (
                1 + st["retries"] if kname == tq.KERNEL_NAME else None)
            if got < 1 or (exp is not None and got != exp):
                raise AssertionError(f"{name} (worker {res['rank']}): "
                                     f"{kname} launched {got} times")
            if kname not in st["kernel_checks"]:
                raise AssertionError(f"{name}: no {kname} launch held "
                                     f"against its plain version")
        launches[kname] = sum(res[name]["launches"].get(kname, 0)
                              for res in results)
    out["dist_launches"] = launches
    for name in names:
        st = [res[name] for res in results]
        out[name] = {"phase": name, "workers": st,
                     "read_ms": max(s["read_ms"] for s in st),
                     "host_bytes_sent": sum(s["host_bytes_sent"]
                                            for s in st),
                     "host_ms": max(s["host_ms"] for s in st),
                     "retries": _both(results, name, "retries"),
                     "peak_device_bytes": _both(results, name,
                                                "peak_device_bytes"),
                     "ok": True}
    out["dist_full"].update(
        integrity=_both(results, "dist_full", "integrity"),
        integrity_bytes=_both(results, "dist_full", "integrity_bytes"))
    out["dist_replay"].update(
        replays=_both(results, "dist_replay", "replays"),
        spent=_both(results, "dist_replay", "spent"),
        replay_ms=_both(results, "dist_replay", "replay_ms"))
    # dist_peer_loss: worker 1 is killed once both staged
    t = time.perf_counter()
    loss = run_cluster(
        "chaos", DIST_PROCS, SHARDS, device=None, timeout_s=DIST_DEADLINE_S,
        conf={"spark.shuffle.tpu.failure.collectiveTimeoutMs":
              str(DIST_FENCE_MS)},
        args={"maps": MAPS, "rows": DIST_LOSS_ROWS})
    survivor = loss.results[0]
    if not (survivor["peer_lost"] and loss.results[1] is None
            and survivor["wall_ms"] < 2 * DIST_FENCE_MS):
        raise AssertionError(f"dist_peer_loss: {loss.results}")
    out["dist_peer_loss"] = {"phase": "dist_peer_loss",
                             "fence_ms": DIST_FENCE_MS,
                             "survivor_wall_ms": survivor["wall_ms"],
                             "expiries": survivor["expiries"],
                             "error": survivor["error"],
                             "seconds": time.perf_counter() - t, "ok": True}
    return out


# -- the failure plane: fault injection, retry, replay, the recovery ledger,
# and the pool / fetch surface (runtime/failures.py, shuffle/manager.py) --
FAULT_SMALL_RECORDS = RECORDS // 8   # the budget / retry / publish cases
WAVE_FAULT_RATE = 0.25


def wave_fault_seed(num_maps: int, num_waves: int,
                    rate: float = WAVE_FAULT_RATE) -> tuple:
    """(seed, wave): the first ``fault.seed`` under which a conf with
    ``fault.wave.failRate=rate`` lets a waved read's first attempt pass,
    fails its second at its middle wave and lets the replay pass — by
    the port's own FaultInjector over the sites such a node checks in
    order (a commit per map, then per attempt the fetch, each map's
    ``corrupt.staged`` site at the default staged verify, the exchange
    and one check per wave until one fires)."""
    from sparkucx_tpu_torch.config import ShuffleConf
    from sparkucx_tpu_torch.runtime.failures import (FaultInjector,
                                                     InjectedFault)
    target = num_waves // 2
    head = ["fetch"] + ["corrupt.staged"] * num_maps + ["exchange"]
    attempt = head + ["wave"] * num_waves
    for seed in range(1, 1 << 20):
        fi = FaultInjector(ShuffleConf({PFX + "fault.wave.failRate":
                                        str(rate), PFX + "fault.seed":
                                        str(seed)}, use_env=False))
        fired = []
        for site in ["publish"] * num_maps:
            fi.check(site)
        for n, sites in enumerate((attempt, attempt, attempt)):
            for i, site in enumerate(sites):
                try:
                    fi.check(site)
                except InjectedFault:
                    fired.append((n, i - len(head)))
                    break
        if fired == [(1, target)]:
            return seed, target
    raise AssertionError("no fault.seed fires once at the middle wave")


def _cold_host_cache() -> None:
    """Free what this process cached on the card and its page-locked host
    blocks, so the next node pins from nothing."""
    import gc

    import torch
    from sparkucx_tpu_torch.runtime.node import _empty_host_cache
    gc.collect()
    torch.cuda.empty_cache()
    _empty_host_cache()


def faults_single(dev, keys, values, main_digests: dict,
                  main_launches: int) -> dict:
    """faults_single, then faults_ledger on the same node: main's shuffle
    under ``a2a.impl=pallas``, ``failure.policy=replay`` and
    ``fault.exchange.failCount=1``; then a remesh to the same 8 shards
    and the stale handle's read through the recovery ledger."""
    import gc

    import torch
    from sparkucx_tpu_torch import backend, connect
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME as A2A
    conf = {PFX + "a2a.impl": "pallas", **REPLAY_CONF,
            PFX + "fault.exchange.failCount": "1"}
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        pool = svc.node.pool
        sizes = []
        get = pool.get
        pool.get = lambda n: (sizes.append(int(n)), get(n))[1]
        h = write_maps(svc, 90, keys, values, MAPS)
        staging = list(sizes)
        staged = pool.stats()["in_use_bytes"]
        gc.collect()
        torch.cuda.synchronize(dev)
        mem0 = torch.cuda.memory_allocated(dev)
        backend.reset_launch_counts()
        parts, read_ms, views_ms = drive_read(svc, h)
        launches = backend.launch_counts()
        pack = sorted(set(sizes[len(staging):]))
        del pool.get
        rep = svc.report(90)
        stats = svc.node.faults.stats()
        if partition_digests(parts) != main_digests:
            raise AssertionError("faults_single: partitions differ from "
                                 "main's")
        del parts
        in_use_after = pool.stats()["in_use_bytes"]
        gc.collect()
        torch.cuda.synchronize(dev)
        mem_after = torch.cuda.memory_allocated(dev)
        if not (rep.replays == 1 and rep.replay_ms > 0
                and stats["exchange"] == (2, 1)
                and launches.get(A2A, 0) == main_launches
                and in_use_after == staged and mem_after == mem0):
            raise AssertionError(
                f"faults_single: replays={rep.replays} replay_ms="
                f"{rep.replay_ms} exchange={stats.get('exchange')} "
                f"launches={launches} (main {main_launches}) pool "
                f"{in_use_after}/{staged} B device {mem_after}/{mem0} B")
        single = {"phase": "faults_single", "read_ms": read_ms,
                  "views_ms": views_ms, "replays": rep.replays,
                  "replay_ms": rep.replay_ms, "pack_ms": rep.pack_ms,
                  "exchange_stats": list(stats["exchange"]),
                  "launches": launches, "pool_in_use_after": in_use_after, "pool_staged": staged,
                  "device_bytes_before": mem0, "device_bytes_after":
                      mem_after, "ok": True}
        # faults_ledger: a remesh to the same 8 shards; the stale handle
        # re-pins through the recovery ledger and replays once
        t = time.perf_counter()
        svc.node.remesh(SHARDS, reason="faults_ledger drill")
        backend.reset_launch_counts()
        parts, lread_ms, _ = drive_read(svc, h)
        lrep = svc.report(90)
        ok = partition_digests(parts) == main_digests
        del parts
        if not (ok and lrep.replays == 1 and h.epoch == 1):
            raise AssertionError(f"faults_ledger: digests equal {ok}, "
                                 f"replays {lrep.replays}, epoch {h.epoch}")
        ledger = {"phase": "faults_ledger", "read_ms": lread_ms,
                  "replays": lrep.replays, "epoch": h.epoch,
                  "launches": backend.launch_counts(),
                  "seconds": time.perf_counter() - t, "ok": True}
        svc.unregister_shuffle(90)
        if pool.stats()["in_use_bytes"]:
            raise AssertionError("faults_single: the pool still holds "
                                 "staging after unregister")
    return single, ledger, {"staging": staging, "pack": pack}


def faults_small(dev, keys, values) -> dict:
    """The budget, retry and publish cases on an eighth of main's
    records: ``failure.replayBudget=1`` with ``failCount=5`` raises
    InjectedFault after 2 injections; ``fault.fetch.failCount=2`` under
    failfast is absorbed by the retry policy (3 fetch attempts, 2 retry
    observations); a ``publish`` fault surfaces at commit."""
    from sparkucx_tpu_torch import connect
    from sparkucx_tpu_torch.runtime.failures import InjectedFault
    from sparkucx_tpu_torch.utils.metrics import H_RETRY_MS
    n = FAULT_SMALL_RECORDS
    sk, sv = keys[:n], values[:n]
    out = {"phase": "faults_small", "records": n}
    conf = {PFX + "a2a.impl": "pallas", **REPLAY_CONF,
            PFX + "failure.replayBudget": "1",
            PFX + "fault.exchange.failCount": "5"}
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        h = write_maps(svc, 91, sk, sv, MAPS)
        try:
            svc.read(h)
            raise AssertionError("faults_small: the budget did not run out")
        except InjectedFault as e:
            out["budget_error"] = str(e)
        out["budget_exchange"] = list(svc.node.faults.stats()["exchange"])
        if out["budget_exchange"][1] != 2:
            raise AssertionError(f"faults_small: {out}")
    conf = {PFX + "a2a.impl": "pallas", PFX + "fault.fetch.failCount": "2",
            PFX + "fault.publish.failCount": "1"}
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        h = svc.register_shuffle(92, MAPS, PARTITIONS)
        per = -(-n // MAPS)
        w = svc.writer(h, 0)
        w.write(sk[:per], sv[:per])
        try:
            w.commit(PARTITIONS)
            raise AssertionError("faults_small: the publish fault did not "
                                 "surface")
        except InjectedFault as e:
            out["publish_error"] = str(e)
        for m in range(MAPS):
            svc.write(h, m, sk[m * per:(m + 1) * per],
                      sv[m * per:(m + 1) * per])
        parts, read_ms, _ = drive_read(svc, h)
        check_against_oracle(parts, sk, sv, PARTITIONS)
        del parts
        out["fetch"] = list(svc.node.faults.stats()["fetch"])
        out["retry_observations"] = svc.node.metrics.histogram(
            H_RETRY_MS).count
        out["fetch_read_ms"] = read_ms
        if out["fetch"] != [3, 2] or out["retry_observations"] != 2:
            raise AssertionError(f"faults_small: {out}")
    out["ok"] = True
    return out


def faults_waved(dev) -> dict:
    """waved_combine's records and conf (``a2a.impl=dense``, 5 waves,
    device sink, the merge fold) under replay with
    ``fault.wave.failRate`` and a ``fault.seed`` chosen here so the first
    read passes and the second fails at its middle wave: the sums equal
    the oracle on both, the in-flight waves settle and the whole
    exchange re-runs (the segment reduce launched once more per settled
    wave, the merge not at all for the failed attempt), and the peak is
    no higher than the fault-free read's plus one wave's buffers."""
    from sparkucx_tpu_torch import connect
    from sparkucx_tpu_torch.ops.segmented import KERNEL_NAME as SEG
    from sparkucx_tpu_torch.ops.segmented import MERGE_KERNEL_NAME as MERGE
    keys, values = make_combine_records(RECORDS, SEED + 4)
    waves = -(-(RECORDS // SHARDS) // WAVE_ROWS)
    seed, wave = wave_fault_seed(MAPS, waves)
    print(json.dumps({"phase": "faults_waved_plan", "fault_seed": seed,
                      "fail_rate": WAVE_FAULT_RATE, "fails_at_wave": wave,
                      "waves": waves}), flush=True)
    uk, sums, _ = group_oracle(keys, values)
    want = (sums & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    conf = {**WAVE_CONF, PFX + "read.mergeImpl": "auto", **REPLAY_CONF,
            PFX + "fault.wave.failRate": str(WAVE_FAULT_RATE),
            PFX + "fault.seed": str(seed)}
    reads = []
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        h = write_maps(svc, 93, keys, values, MAPS)
        for _ in range(2):
            parts, st, rep = waved_read(svc, h, dev, combine="sum")
            gk, gv = combined_rows(parts, PARTITIONS,
                                   lambda k: hash_pid(k, PARTITIONS))
            if not (np.array_equal(gk, uk) and np.array_equal(gv, want)):
                raise AssertionError("faults_waved: sums differ from the "
                                     "oracle")
            del parts, gk, gv
            reads.append((st, rep.replays, rep.replay_ms,
                          rep.plan_bucket))
        stats = svc.node.faults.stats()
        svc.unregister_shuffle(93)
    (base, r0, _, _), (faulted, r1, replay_ms, bucket) = reads
    f2, f3 = (base["launches"].get(k, 0) for k in (MERGE, SEG))
    t2, t3 = (faulted["launches"].get(k, 0) for k in (MERGE, SEG))
    per_wave = (f3 - f2) // waves
    wave_bytes = (bucket[0] + bucket[1]) * (2 + COMBINE_VALUE_WORDS) * 4 \
        * SHARDS
    out = {"phase": "faults_waved", "records": RECORDS, "waves": waves,
           "fault_seed": seed, "fails_at_wave": wave,
           "replays": [r0, r1], "replay_ms": replay_ms,
           "wave_stats": list(stats["wave"]),
           "fault_free": {"read_ms": base["read_ms"],
                          "peak_device_bytes": base["peak_device_bytes"],
                          "launches": base["launches"]},
           "replayed": {"read_ms": faulted["read_ms"],
                        "peak_device_bytes": faulted["peak_device_bytes"],
                        "launches": faulted["launches"]},
           "one_wave_bytes": wave_bytes}
    # a wave's exchange launches the segment reduce once and each fold
    # step a merge and a segment reduce; the failed attempt settled
    # ``wave`` waves and folded none
    if not (r0 == 0 and r1 == 1 and (f3 - f2) % waves == 0
            and t2 == f2 and t3 == f3 + wave * per_wave
            and faulted["peak_device_bytes"]
            <= base["peak_device_bytes"] + wave_bytes):
        raise AssertionError(f"faults_waved: {out}")
    out["ok"] = True
    return out


def faults_tiered(dev) -> dict:
    """hier_int8's gradient rows on the 2 x 4 grid under replay with
    ``fault.tier.dcn.failCount=1`` and the flight recorder on: the ring
    holds a ``tier_fault`` naming dcn, and the replayed read's partitions
    equal a fault-free read's whose exchange drew the same int8 noise (a
    small read first, so its read is the node's second exchange, as the
    replay is). Prints the quantize launches of both."""
    from sparkucx_tpu_torch import backend, connect
    from sparkucx_tpu_torch.ops.quant import KERNEL_NAME as QUANT
    ikeys, grads = make_embedding_grads(INT8_RECORDS, SEED + 11)
    wk, wg = ikeys[:1 << 14], grads[:1 << 14]
    flight_dir = tempfile.mkdtemp(prefix="chip_smoke_flight_")
    base = {**HIER_CONF, PFX + "a2a.wire": "int8", **REPLAY_CONF}
    out = {"phase": "faults_tiered", "records": INT8_RECORDS}
    digests = {}
    try:
        for arm, extra in (("fault_free", {}),
                           ("replayed", {
                               PFX + "fault.tier.dcn.failCount": "1",
                               PFX + "flightRecorder.enabled": "true",
                               PFX + "flightRecorder.dir": flight_dir})):
            with connect({**base, **extra}, num_shards=SHARDS,
                         use_env=False) as svc:
                if arm == "fault_free":
                    drive_read(svc, write_maps(svc, 94, wk, wg, 8))
                    svc.unregister_shuffle(94)
                h = write_maps(svc, 95, ikeys, grads, MAPS)
                backend.reset_launch_counts()
                parts, read_ms, _ = drive_read(svc, h)
                rep = svc.report(95)
                digests[arm] = partition_digests(parts)
                del parts
                out[arm] = {"read_ms": read_ms, "replays": rep.replays,
                            "replay_ms": rep.replay_ms,
                            "retries": rep.retries, "wire": rep.wire,
                            "hierarchical": rep.hierarchical,
                            "quantize_launches":
                                backend.launch_counts().get(QUANT, 0)}
                if arm == "replayed":
                    ring = [e for e in svc.node.flight.events()
                            if e["kind"] in ("fault", "tier_fault",
                                             "replay")]
                    out["ring"] = ring
                    out["dcn_stats"] = list(
                        svc.node.faults.stats()["tier.dcn"])
                svc.unregister_shuffle(95)
    finally:
        shutil.rmtree(flight_dir, ignore_errors=True)
    ff, rp = out["fault_free"], out["replayed"]
    if not (digests["fault_free"] == digests["replayed"]
            and rp["replays"] == 1 and ff["replays"] == 0
            and rp["wire"] == "int8" and rp["hierarchical"]
            and any(e["kind"] == "tier_fault" and e["tier"] == "dcn"
                    for e in out["ring"])
            and ff["quantize_launches"] == 2 + ff["retries"]):
        raise AssertionError(f"faults_tiered: {out}")
    out["ok"] = True
    return out


def faults_surface(dev, keys, values, main_digests: dict,
                   blocks: dict) -> dict:
    """main's cold read (torch's page-locked cache emptied, a fresh node)
    without and with ``memory.preAllocateBuffers`` sized from the staging
    and pack blocks faults_single's read checked out; the second node also
    fetches by partition (``io.fetchGranularity=partition``):
    ``partition(0)``'s bytes against the shard fetch's, and the wall of
    the pass over every partition after it under each fetch; and
    ``read_partitions(h, 0, 16)`` against the first node's partitions."""
    from collections import Counter

    from sparkucx_tpu_torch import connect
    spec = Counter(blocks["staging"])
    for size in blocks["pack"]:
        spec[size] += 1
    prealloc = ",".join(f"{s}:{c}" for s, c in sorted(spec.items()))
    out = {"phase": "faults_surface", "preallocate": prealloc}
    base = {PFX + "a2a.impl": "pallas"}
    for arm, extra in (("cold", {}),
                       ("preallocated", {
                           PFX + "memory.preAllocateBuffers": prealloc,
                           PFX + "io.fetchGranularity": "partition"})):
        _cold_host_cache()
        t0 = time.perf_counter()
        with connect({**base, **extra}, num_shards=SHARDS,
                     use_env=False) as svc:
            start_s = time.perf_counter() - t0
            t = time.perf_counter()
            h = write_maps(svc, 96, keys, values, MAPS)
            write_s = time.perf_counter() - t
            t = time.perf_counter()
            res = svc.read(h)
            import torch
            torch.cuda.synchronize(dev)
            read_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            k0, v0 = res.partition(0)
            p0_ms = (time.perf_counter() - t) * 1e3
            p0_bytes = svc.report(96).d2h_bytes
            t = time.perf_counter()
            parts = [res.partition(r) for r in range(PARTITIONS)]
            pass_ms = (time.perf_counter() - t) * 1e3
            ok = partition_digests(parts) == main_digests
            st = svc.node.pool.stats()
            out[arm] = {"node_start_s": start_s, "write_s": write_s,
                        "read_ms": read_ms, "pack_ms": svc.report(96).pack_ms,
                        "partition0_ms": p0_ms, "partition0_rows":
                            int(k0.shape[0]),
                        "partition0_d2h_bytes": p0_bytes,
                        "all_partitions_ms": pass_ms,
                        "d2h_bytes": svc.report(96).d2h_bytes,
                        "pool_peak_bytes": st["peak_bytes"],
                        "preallocated": st["preallocated"],
                        "allocated": st["allocated"]}
            if not ok:
                raise AssertionError(f"faults_surface ({arm}): partitions "
                                     f"differ from main's")
            if arm == "cold":
                ranged = dict(svc.manager.read_partitions(h, 0, 16))
                if sorted(ranged) != list(range(16)) or any(
                        partition_digest(*ranged[r])
                        != partition_digest(*parts[r]) for r in range(16)):
                    raise AssertionError("faults_surface: read_partitions "
                                         "differs from partition(0..15)")
                out["read_partitions"] = {"partitions": 16, "equal": True}
            del res, parts
            svc.unregister_shuffle(96)
    width = 2 + VALUE_WORDS
    pa = out["preallocated"]
    # (a CPU view costs no copy, so only the card counts D2H bytes)
    moved = dev.type != "cuda" or (
        pa["partition0_d2h_bytes"] == pa["partition0_rows"] * width * 4
        and out["cold"]["partition0_d2h_bytes"]
        > pa["partition0_d2h_bytes"])
    if not (moved and pa["preallocated"] == sum(spec.values())):
        raise AssertionError(f"faults_surface: {out}")
    out["ok"] = True
    return out


def faults_phase(dev, main_digests: dict, main_launches: int) -> dict:
    """The failure plane on the card (module docstring, phase 36)."""
    t = time.perf_counter()
    keys, values = make_records(RECORDS, zipf=False, seed=SEED)
    out = {"gen_s": time.perf_counter() - t}
    single, ledger, blocks = faults_single(dev, keys, values, main_digests,
                                           main_launches)
    out["faults_single"], out["faults_ledger"] = single, ledger
    out["faults_small"] = faults_small(dev, keys, values)
    out["faults_surface"] = faults_surface(dev, keys, values, main_digests,
                                           blocks)
    del keys, values
    out["faults_waved"] = faults_waved(dev)
    out["faults_tiered"] = faults_tiered(dev)
    return out


# -- the integrity and durability plane (shuffle/integrity.py,
# shuffle/durable.py): the verify levels, the corrupt sites, the modes'
# verdicts and the restart drill --------------------------------------------
CORRUPT_OFFSET = 4097          # the corrupt sites' byte
RESTART_SID = 110
RESTART_QUARANTINED_MAP = 17


def _timed_method(mgr, name: str, walls: list) -> None:
    """Record the wall (ms) of each call of ``mgr``'s method ``name``
    (its callers look it up on the instance at call time)."""
    real = getattr(mgr, name)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            walls.append((time.perf_counter() - t0) * 1e3)

    setattr(mgr, name, timed)


def integrity_levels(dev, keys, values, main_digests: dict,
                     main_launches: int, main_line: dict) -> dict:
    """main's shuffle on a fresh ``a2a.impl=pallas`` node at each
    ``integrity.verify`` level (``off``, ``staged`` — the default — and
    ``full``; each node reads a small warm-up shuffle first), beside
    main's own read: the 64 commits' wall, the read's wall, pack and
    verified bytes, the staged verify's wall and, at ``full``, the
    post-exchange verify's, and the segment move's launches. Every
    level's partitions give main's digests and launch the segment move
    as often as main."""
    from sparkucx_tpu_torch import backend, connect
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME as A2A
    payload = int(keys.nbytes + values.nbytes)
    out = {"phase": "integrity_levels", "main": {
        "commit_s": main_line["main_write_s"],
        "read_ms": main_line["main_read_ms"],
        "pack_ms": main_line["main_pack_ms"],
        "integrity": main_line["main_integrity"],
        "integrity_bytes": main_line["main_integrity_bytes"],
        "launches": main_launches}}
    if (out["main"]["integrity"], out["main"]["integrity_bytes"]) != \
            ("staged", payload):
        raise AssertionError(f"main's staged verify: {out['main']}")
    wk, wv = make_records(1 << 16, zipf=False, seed=SEED + 1)
    want = {"off": ("", 0), "staged": ("staged", payload),
            "full": ("full", 2 * payload)}
    for level in ("off", "staged", "full"):
        with connect({PFX + "a2a.impl": "pallas",
                      PFX + "integrity.verify": level},
                     num_shards=SHARDS, use_env=False) as svc:
            drive_read(svc, write_maps(svc, 1, wk, wv, 8))
            svc.unregister_shuffle(1)
            walls, staged_walls = [], []
            _timed_method(svc.manager, "_verify_full_result", walls)
            _timed_method(svc.manager, "_verified_materialize", staged_walls)
            t = time.perf_counter()
            h = write_maps(svc, 111, keys, values, MAPS)
            commit_s = time.perf_counter() - t
            backend.reset_launch_counts()
            parts, read_ms, views_ms = drive_read(svc, h)
            launches = backend.launch_counts().get(A2A, 0)
            rep = svc.report(111)
            same = partition_digests(parts) == main_digests
            del parts
            svc.unregister_shuffle(111)
        st = {"commit_s": commit_s, "read_ms": read_ms,
              "views_ms": views_ms, "pack_ms": rep.pack_ms,
              "integrity": rep.integrity,
              "integrity_bytes": rep.integrity_bytes,
              "staged_verify_ms": staged_walls, "verify_ms": walls,
              "launches": launches}
        if not (same and launches == main_launches
                and (rep.integrity, rep.integrity_bytes) == want[level]
                and len(staged_walls) == (level != "off")
                and len(walls) == (level == "full")):
            raise AssertionError(f"integrity_levels ({level}): digests "
                                 f"equal {same}, {st}")
        out[level] = st
    return {**out, "ok": True}


def integrity_corrupt(dev, keys, values) -> dict:
    """The corrupt sites on an eighth of main's records: a
    ``corrupt.staged`` flip under failfast raises ``BlockCorruptionError``
    naming map 0's staged arena with a ``block_corruption`` ring event
    and no launch, and a clean re-read equals the oracle; the same flip
    under replay costs one replay; a ``corrupt.spill`` flip on spilled
    writers is found through the mapped views and undone (the file's
    crc32 as before)."""
    from sparkucx_tpu_torch import backend, connect
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME as A2A
    from sparkucx_tpu_torch.runtime.failures import BlockCorruptionError
    from sparkucx_tpu_torch.shuffle.integrity import crc32_file
    from sparkucx_tpu_torch.utils.metrics import C_INTEGRITY_CORRUPT_BLOCKS
    n = FAULT_SMALL_RECORDS
    sk, sv = keys[:n], values[:n]
    staged = {PFX + "fault.corrupt.staged.failCount": "1",
              PFX + "fault.corrupt.staged.offset": str(CORRUPT_OFFSET)}
    base = {PFX + "a2a.impl": "pallas"}
    out = {"phase": "integrity_corrupt", "records": n}
    launches = 0
    root = tempfile.mkdtemp(prefix="chip_smoke_integrity_")
    try:
        conf = {**base, **staged, PFX + "flightRecorder.enabled": "true",
                PFX + "flightRecorder.dir": os.path.join(root, "flight")}
        with connect(conf, num_shards=SHARDS, use_env=False) as svc:
            h = write_maps(svc, 120, sk, sv, MAPS)
            backend.reset_launch_counts()
            try:
                svc.read(h)
                raise AssertionError("corrupt.staged: the read returned")
            except BlockCorruptionError as e:
                msg = str(e)
            failed_launches = backend.launch_counts().get(A2A, 0)
            events = [e for e in svc.node.flight.events()
                      if e["kind"] == "block_corruption"]
            parts, read_ms, _ = drive_read(svc, h)
            check_against_oracle(parts, sk, sv, PARTITIONS)
            del parts
            launches += backend.launch_counts().get(A2A, 0)
            svc.unregister_shuffle(120)
        block = "map 0 (map 0 staged arena)"
        if not (block in msg and failed_launches == 0 and len(events) == 1
                and events[0]["block"] == block):
            raise AssertionError(f"corrupt.staged failfast: {msg!r}, "
                                 f"{failed_launches} launches, {events}")
        out["failfast"] = {"error": msg[:200], "block": events[0]["block"],
                           "launches_before_raise": failed_launches,
                           "reread_ms": read_ms}
        with connect({**base, **staged, **REPLAY_CONF}, num_shards=SHARDS,
                     use_env=False) as svc:
            h = write_maps(svc, 121, sk, sv, MAPS)
            backend.reset_launch_counts()
            parts, read_ms, _ = drive_read(svc, h)
            got = backend.launch_counts().get(A2A, 0)
            launches += got
            check_against_oracle(parts, sk, sv, PARTITIONS)
            del parts
            rep = svc.report(121)
            blocks = svc.node.metrics.get(C_INTEGRITY_CORRUPT_BLOCKS)
            svc.unregister_shuffle(121)
        if not (rep.replays == 1 and got == 1 and blocks == 1):
            raise AssertionError(f"corrupt.staged replay: replays "
                                 f"{rep.replays}, launches {got}, blocks "
                                 f"{blocks}")
        out["replay"] = {"replays": rep.replays, "replay_ms": rep.replay_ms,
                         "read_ms": read_ms, "launches": got}
        sdir = os.path.join(root, "spill")
        conf = {**base, **REPLAY_CONF, PFX + "spill.threshold": "1m",
                PFX + "spill.dir": sdir,
                PFX + "fault.corrupt.spill.failCount": "1",
                PFX + "fault.corrupt.spill.offset": str(CORRUPT_OFFSET)}
        with connect(conf, num_shards=SHARDS, use_env=False) as svc:
            h = write_maps(svc, 122, sk, sv, MAPS)
            path = os.path.join(sdir, "shuffle_122_map_0.keys")
            crc0 = crc32_file(path)
            backend.reset_launch_counts()
            parts, read_ms, _ = drive_read(svc, h)
            got = backend.launch_counts().get(A2A, 0)
            launches += got
            check_against_oracle(parts, sk, sv, PARTITIONS)
            del parts
            rep = svc.report(122)
            fired = svc.node.faults.stats()["corrupt.spill"][1]
            spilled = svc.stats()["counters"]["shuffle.spill.count"]
            undone = crc32_file(path) == crc0
            svc.unregister_shuffle(122)
        if not (rep.replays == 1 and fired == 1 and undone and got == 1
                and spilled >= MAPS):
            raise AssertionError(f"corrupt.spill: replays {rep.replays}, "
                                 f"fired {fired}, undone {undone}, "
                                 f"launches {got}, spills {spilled}")
        out["spill"] = {"replays": rep.replays, "read_ms": read_ms,
                        "spills": spilled, "crc32_restored": undone,
                        "launches": got}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {**out, "launches": {A2A: launches}, "ok": True}


def integrity_modes(dev) -> dict:
    """The full level's verdict per read mode: waved_combine's device-sink
    read samples the merged view's key lanes (``integrity_bytes`` = the
    staged bytes + 8 B a delivered row, ``d2h_bytes`` = the sampled
    copy); the int8 plain host read verifies key-only digests; a combine
    host read verifies the staged bytes only (the report names the
    configured level, as the JAX package's does). Each against its
    phase's oracle."""
    import torch
    from sparkucx_tpu_torch import backend, connect
    from sparkucx_tpu_torch.ops import quant as tq
    from sparkucx_tpu_torch.ops import segmented as sg
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME as A2A
    full = {PFX + "integrity.verify": "full"}
    out = {"phase": "integrity_modes"}
    ck, cv = make_combine_records(RECORDS, SEED + 4)
    staged = int(ck.nbytes + cv.nbytes)
    uk, sums, _ = group_oracle(ck, cv)
    want = (sums & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    conf = {**WAVE_CONF, PFX + "read.mergeImpl": "auto", **full}
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        walls = []
        _timed_method(svc.manager, "_verify_full_result", walls)
        h = write_maps(svc, 130, ck, cv, MAPS)
        backend.reset_launch_counts()
        t0 = time.perf_counter()
        res = svc.read(h, combine="sum", sink="device")
        torch.cuda.synchronize(dev)
        read_ms = (time.perf_counter() - t0) * 1e3
        launches = backend.launch_counts()
        rep = svc.report(130)
        rows = res.device_rows()
        delivered = int(res.device_totals().sum())
        sampled = rows.shape[0] * rows.shape[1] * 8
        st = {"read_ms": read_ms, "waves": rep.waves, "merge_ms":
              rep.merge_ms, "integrity": rep.integrity,
              "integrity_bytes": rep.integrity_bytes,
              "d2h_bytes": rep.d2h_bytes, "verify_ms": walls,
              "launches": launches}
        del rows
        hv = res.host_view()
        gk, gv = combined_rows([hv.partition(r) for r in range(PARTITIONS)],
                               PARTITIONS, lambda k: hash_pid(k, PARTITIONS))
        del hv, res
        svc.unregister_shuffle(130)
    if not (np.array_equal(gk, uk) and np.array_equal(gv, want)):
        raise AssertionError("integrity_modes (waved device combine): sums "
                             "differ from the oracle")
    if not (rep.waves == 5 and rep.integrity == "full"
            and rep.integrity_bytes == staged + 8 * delivered
            and st["d2h_bytes"] == sampled
            and launches.get(sg.MERGE_KERNEL_NAME, 0) == 4
            and launches.get(sg.KERNEL_NAME, 0) >= 9):
        raise AssertionError(f"integrity_modes (waved device combine): "
                             f"{st}, staged {staged}, delivered "
                             f"{delivered}, sampled {sampled}")
    out["waved_combine_device"] = st
    # a combine host read: the staged verify only
    conf = {PFX + "a2a.impl": "pallas", PFX + "read.mergeImpl": "auto",
            **full}
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        h = write_maps(svc, 132, ck, cv, MAPS)
        backend.reset_launch_counts()
        parts, read_ms, views_ms = drive_read(svc, h, combine="sum")
        claunches = backend.launch_counts()
        crep = svc.report(132)
        gk, gv = combined_rows(parts, PARTITIONS,
                               lambda k: hash_pid(k, PARTITIONS))
        del parts
        svc.unregister_shuffle(132)
    if not (np.array_equal(gk, uk) and np.array_equal(gv, want)):
        raise AssertionError("integrity_modes (combine host): sums differ")
    if not ((crep.integrity, crep.integrity_bytes) == ("full", staged)
            and claunches.get(sg.KERNEL_NAME, 0) >= 1):
        raise AssertionError(f"integrity_modes (combine host): "
                             f"{crep.integrity} {crep.integrity_bytes} B "
                             f"(staged {staged}), launches {claunches}")
    out["combine_host"] = {"read_ms": read_ms, "integrity": crep.integrity,
                           "integrity_bytes": crep.integrity_bytes,
                           "launches": claunches}
    del ck, cv, uk, sums, want, gk, gv
    # the int8 plain host read: key-only digests
    n8 = INT8_RECORDS // 8
    ikeys, grads = make_embedding_grads(n8, SEED + 11)
    conf = {PFX + "a2a.impl": "pallas", PFX + "a2a.wire": "int8", **full}
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        walls = []
        _timed_method(svc.manager, "_verify_full_result", walls)
        h = write_maps(svc, 131, ikeys, grads, MAPS)
        backend.reset_launch_counts()
        parts, read_ms, views_ms = drive_read(svc, h)
        ilaunches = backend.launch_counts()
        irep = svc.report(131)
        svc.unregister_shuffle(131)
    ipid = hash_pid(ikeys, PARTITIONS)
    for r in range(PARTITIONS):
        if not np.array_equal(np.sort(parts[r][0]), np.sort(ikeys[ipid == r])):
            raise AssertionError(f"integrity_modes (int8): partition {r} "
                                 f"keys differ")
    del parts
    istaged = int(ikeys.nbytes + grads.nbytes)
    if not (irep.wire == "int8" and irep.integrity == "full"
            and irep.integrity_bytes == istaged + int(ikeys.nbytes)
            and ilaunches.get(tq.KERNEL_NAME, 0) == 1 + irep.retries
            and ilaunches.get(A2A, 0) == 1 + irep.retries):
        raise AssertionError(f"integrity_modes (int8): {irep.wire} "
                             f"{irep.integrity} {irep.integrity_bytes} B, "
                             f"launches {ilaunches}")
    out["int8_plain_host"] = {"records": n8, "read_ms": read_ms,
                              "integrity": irep.integrity,
                              "integrity_bytes": irep.integrity_bytes,
                              "verify_ms": walls, "launches": ilaunches}
    out["launches"] = {k: launches.get(k, 0) + claunches.get(k, 0)
                       + ilaunches.get(k, 0)
                       for k in (A2A, sg.MERGE_KERNEL_NAME, sg.KERNEL_NAME,
                                 tq.KERNEL_NAME)}
    return {**out, "ok": True}


def restart_child(ledger: str, conn) -> None:
    """The restart drill's writer (a ``spawn`` child): it loads the
    kernel library the parent built, connects on the card under
    ``failure.ledgerDir=ledger``, writes and commits main's 64 maps,
    sends its figures and kills itself with SIGKILL — no ``stop()``, no
    ``close()``."""
    import signal

    from sparkucx_tpu_torch import backend, connect
    t = time.perf_counter()
    backend.kernel_library()
    load_s = time.perf_counter() - t
    keys, values = make_records(RECORDS, zipf=False, seed=SEED)
    svc = connect({PFX + "failure.ledgerDir": ledger}, num_shards=SHARDS,
                  use_env=False)
    t = time.perf_counter()
    write_maps(svc, RESTART_SID, keys, values, MAPS)
    commit_s = time.perf_counter() - t
    conn.send({"commit_s": commit_s, "kernel_load_s": load_s,
               "rebuilt": bool(backend.build_log),
               "launches": backend.launch_counts(),
               "device": str(svc.node.device)})
    os.kill(os.getpid(), signal.SIGKILL)


def restart_drill(dev, keys, values, main_digests: dict,
                  staged_commit_s: float) -> dict:
    """A real crash and restart on the durable ledger: a ``spawn`` child
    commits main's 64 maps durably and is SIGKILLed; the directory holds
    64 sealed ``.keys`` and no ``*.tmp``; a fresh node on it recovers all
    64 maps (the scan's wall), adopts them with zero recompute (a second
    ``get_writer`` refuses) and reads main's digests at the staged level
    from the mapped files; one flipped byte in map 17's ``.vals``
    quarantines that map alone at the next restart, and only it is
    written again; ``unregister_shuffle`` removes the directory."""
    import glob
    import json as _json
    import multiprocessing as mp
    import signal

    from sparkucx_tpu_torch import backend, connect
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME as A2A
    from sparkucx_tpu_torch.shuffle.durable import ShuffleLedger
    from sparkucx_tpu_torch.utils.metrics import C_INTEGRITY_RECOVERED
    out = {"phase": "restart_drill"}
    root = tempfile.mkdtemp(prefix="chip_smoke_ledger_")
    ledger = os.path.join(root, "ledger")
    sdir = os.path.join(ledger, f"shuffle_{RESTART_SID}")
    conf = {PFX + "a2a.impl": "pallas", PFX + "failure.ledgerDir": ledger}
    scans = []
    real_scan = ShuffleLedger.scan

    def timed_scan(self):
        t0 = time.perf_counter()
        try:
            return real_scan(self)
        finally:
            scans.append((time.perf_counter() - t0) * 1e3)

    ShuffleLedger.scan = timed_scan
    launches = 0
    try:
        ctx = mp.get_context("spawn")
        recv, send = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=restart_child, args=(ledger, send))
        t = time.perf_counter()
        proc.start()
        send.close()
        try:
            child = recv.recv()
        finally:
            proc.join(120)
            if proc.is_alive():
                proc.kill()
                proc.join()
        out["child"] = {**child, "exitcode": proc.exitcode,
                        "seconds": time.perf_counter() - t}
        tmp = glob.glob(os.path.join(sdir, "*.tmp"))
        sealed = glob.glob(os.path.join(sdir, "*.keys"))
        if not (proc.exitcode == -signal.SIGKILL and not child["rebuilt"]
                and not child["launches"] and not tmp
                and len(sealed) == MAPS):
            raise AssertionError(f"restart child: {out['child']}, tmp "
                                 f"{tmp}, {len(sealed)} sealed")
        want = {RESTART_SID: {"intact": list(range(MAPS)),
                              "quarantined": []}}
        t = time.perf_counter()
        with connect(conf, num_shards=SHARDS, use_env=False) as svc:
            connect_s = time.perf_counter() - t
            recovered = svc.recovered_shuffles()
            h = svc.register_shuffle(RESTART_SID, MAPS, PARTITIONS)
            try:
                svc.writer(h, 0)
                refused = ""
            except RuntimeError as e:
                refused = str(e)
            in_use0 = svc.node.pool.stats()["in_use_bytes"]
            backend.reset_launch_counts()
            parts, read_ms, views_ms = drive_read(svc, h)
            got = backend.launch_counts().get(A2A, 0)
            launches += got
            rep = svc.report(RESTART_SID)
            same = partition_digests(parts) == main_digests
            del parts
            in_use1 = svc.node.pool.stats()["in_use_bytes"]
            count = svc.node.metrics.get(C_INTEGRITY_RECOVERED)
        st = {"connect_s": connect_s, "scan_ms": list(scans),
              "recovered": {str(k): {"intact": len(v["intact"]),
                                     "quarantined": v["quarantined"]}
                            for k, v in recovered.items()},
              "read_ms": read_ms, "views_ms": views_ms,
              "pack_ms": rep.pack_ms, "integrity": rep.integrity,
              "integrity_bytes": rep.integrity_bytes,
              "recovered_count": count, "launches": got,
              "pool_in_use": [in_use0, in_use1]}
        if not (recovered == want and "already committed" in refused
                and same and rep.integrity == "staged" and count == MAPS
                and got == 1 and in_use1 == in_use0):
            raise AssertionError(f"restart (adopt): {st}, refused "
                                 f"{refused!r}, digests equal {same}")
        out["adopt"] = st
        # rot one sealed block between restarts
        vpath = os.path.join(
            sdir, f"shuffle_{RESTART_SID}_map_{RESTART_QUARANTINED_MAP}.vals")
        with open(vpath, "r+b") as f:
            f.seek(CORRUPT_OFFSET)
            b = f.read(1)
            f.seek(CORRUPT_OFFSET)
            f.write(bytes([b[0] ^ 0xFF]))
        with connect(conf, num_shards=SHARDS, use_env=False) as svc:
            recovered = svc.recovered_shuffles()
            with open(os.path.join(ledger, "quarantine_report.json")) as f:
                report = [(b["shuffle_id"], b["map_id"])
                          for b in _json.load(f)["blocks"]]
            h = svc.register_shuffle(RESTART_SID, MAPS, PARTITIONS)
            missing = [m for m in range(MAPS) if not h.entry.present(m)]
            per = -(-keys.shape[0] // MAPS)
            sl = slice(RESTART_QUARANTINED_MAP * per,
                       (RESTART_QUARANTINED_MAP + 1) * per)
            svc.write(h, RESTART_QUARANTINED_MAP, keys[sl], values[sl])
            backend.reset_launch_counts()
            parts, qread_ms, _ = drive_read(svc, h)
            got = backend.launch_counts().get(A2A, 0)
            launches += got
            same = partition_digests(parts) == main_digests
            del parts
            svc.unregister_shuffle(RESTART_SID)
            gone = not os.path.exists(sdir)
        q = RESTART_QUARANTINED_MAP
        want = {RESTART_SID: {"intact": [m for m in range(MAPS) if m != q],
                              "quarantined": [q]}}
        st = {"scan_ms": scans[-1], "quarantined": [q],
              "report": report, "missing": missing, "read_ms": qread_ms,
              "launches": got, "directory_removed": gone}
        if not (recovered == want and report == [(RESTART_SID, q)]
                and missing == [q] and same and gone and got == 1):
            raise AssertionError(f"restart (quarantine): {st}, recovered "
                                 f"{recovered}, digests equal {same}")
        out["quarantine"] = st
    finally:
        ShuffleLedger.scan = real_scan
        shutil.rmtree(root, ignore_errors=True)
    out["commits"] = {"durable_s": out["child"]["commit_s"],
                      "staged_s": staged_commit_s}
    return {**out, "launches": {A2A: launches}, "ok": True}


def integrity_phase(dev, main_digests: dict, main_launches: int,
                    main_line: dict) -> dict:
    """The integrity and durability plane on the card (module docstring,
    phase 37)."""
    t = time.perf_counter()
    keys, values = make_records(RECORDS, zipf=False, seed=SEED)
    out = {"gen_s": time.perf_counter() - t}
    out["integrity_levels"] = integrity_levels(
        dev, keys, values, main_digests, main_launches, main_line)
    out["integrity_corrupt"] = integrity_corrupt(dev, keys, values)
    out["integrity_modes"] = integrity_modes(dev)
    out["restart_drill"] = restart_drill(
        dev, keys, values, main_digests, main_line["main_write_s"])
    return out


# -- the tenancy plane: tenant policy, fair-share admission, the async read
# plane (shuffle/tenancy.py, the manager's admission) ----------------------
MINNOW_RECORDS = 262_144       # a serving tier's small exchange: 26.2 MB
MINNOW_MAPS = 8
MINNOWS = 8                    # minnow shuffles; the last one is a combine
MINNOW_ROUNDS = 3
WHALE_FLOOD = 4                # whale reads flooded into admission first
TENANCY_DEADLINE_S = 120.0     # any future or wait of the phase
# grants to the whale a minnow ticket may wait through: under DRR the
# whale read that is DRR's cached head when the minnow queues (a whale
# read needs thousands of quanta, a minnow read tens), under FIFO every
# whale read queued ahead of it
FAIR_CROSS_BOUND = 1.0
FIFO_CROSS = float(WHALE_FLOOD - 1)
TENANCY_CONF = {PFX + "a2a.impl": "pallas",          # main's conf
                PFX + "read.mergeImpl": "auto",
                # every future holds a worker: the executor must not be a
                # FIFO queue in front of the admission plane
                PFX + "tenant.asyncWorkers": "16",
                PFX + "tenant.whale.priority": "batch",
                PFX + "tenant.minnow.priority": "high"}
DIST_ASYNC_TENANTS = ("lo", "hi", "hi", "lo", "hi", "lo")


def minnow_data() -> list:
    """The minnow shuffles' records: MINNOWS - 1 of main's row shape and
    one of combine's value shape, with their oracles (partition digests;
    the combine's per-key int32 sums)."""
    out = []
    for i in range(MINNOWS):
        if i == MINNOWS - 1:
            k, v = make_combine_records(MINNOW_RECORDS, SEED + 40)
            uk, sums, _ = group_oracle(k, v)
            want = (uk, (sums & 0xFFFFFFFF).astype(np.uint32)
                    .view(np.int32))
            out.append({"keys": k, "values": v, "combine": True,
                        "want": want})
            continue
        k, v = make_records(MINNOW_RECORDS, zipf=False, seed=SEED + 30 + i)
        pid = hash_pid(k, PARTITIONS)
        order = np.argsort(pid, kind="stable")
        edges = np.searchsorted(pid[order], np.arange(PARTITIONS + 1))
        want = {str(r): partition_digest(k[order[edges[r]:edges[r + 1]]],
                                         v[order[edges[r]:edges[r + 1]]])
                for r in range(PARTITIONS)}
        out.append({"keys": k, "values": v, "combine": False, "want": want})
    return out


def check_minnow(res, m: dict, tag: str) -> None:
    """One minnow result against its oracle: every partition's count and
    row multiset (digests), or the combine's keys and exact sums."""
    parts = [res.partition(r) for r in range(PARTITIONS)]
    if m["combine"]:
        gk, gv = combined_rows(parts, PARTITIONS,
                               lambda k: hash_pid(k, PARTITIONS))
        if not (np.array_equal(gk, m["want"][0])
                and np.array_equal(gv, m["want"][1])):
            raise AssertionError(f"{tag}: combine keys or sums differ "
                                 f"from the oracle")
    elif partition_digests(parts) != m["want"]:
        raise AssertionError(f"{tag}: partitions differ from the oracle")


def _wait_for(pred, what: str) -> None:
    deadline = time.monotonic() + TENANCY_DEADLINE_S
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"tenancy: timed out waiting for {what}")
        time.sleep(0.002)


def _pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


class _TenancyTap:
    """While installed on a manager: every report it makes (a read
    attempt each) and every ``_pack_share`` answer with the tenants
    packing at that moment."""

    def __init__(self, mgr):
        self.mgr, self.reports, self.shares = mgr, [], []

    def __enter__(self) -> "_TenancyTap":
        mgr = self.mgr
        new_report, pack_share = mgr._new_report, mgr._pack_share

        def tap_report(h, *a, **kw):
            rep = new_report(h, *a, **kw)
            self.reports.append(rep)
            return rep

        def tap_share(tenant):
            share = pack_share(tenant)
            with mgr._lock:
                contending = sorted(t for t, n in mgr._packing.items() if n)
            self.shares.append((tenant, share, contending))
            return share

        mgr._new_report, mgr._pack_share = tap_report, tap_share
        return self

    def __exit__(self, *exc) -> None:
        del self.mgr._new_report, self.mgr._pack_share

    def expected_launches(self) -> dict:
        """The launch rule over the read attempts made: the segment move
        once an attempt (and once more a regrow) of a ``pallas`` read
        that dispatched, the segment reduce as often in a combine read
        (the only reads here whose report names the kernel tier)."""
        from sparkucx_tpu_torch.ops import ragged_a2a as ra
        from sparkucx_tpu_torch.ops import segmented as sg
        done = [r for r in self.reports
                if r.completed and r.impl == "pallas"]
        return {ra.KERNEL_NAME: sum(1 + r.retries for r in done),
                sg.KERNEL_NAME: sum(1 + r.retries for r in done
                                    if r.kernel == "pallas")}


def _check_rule(tag: str, tap: "_TenancyTap") -> dict:
    """The launches since the last reset against ``tap``'s launch rule."""
    from sparkucx_tpu_torch import backend
    want = tap.expected_launches()
    launches = backend.launch_counts()
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, the launch rule "
                             f"gives {want}")
    return got


def _hist_snapshot(metrics, name: str) -> dict:
    """The named histogram's snapshot ({} before its first
    observation)."""
    h = metrics.histogram(name)
    return {} if h is None else h.snapshot()


def _tenant_metrics(metrics, tenants) -> dict:
    from sparkucx_tpu_torch.utils import metrics as mt
    out = {}
    for t in tenants:
        wait = _hist_snapshot(metrics,
                              mt.labeled(mt.H_ADMIT_WAIT, tenant=t))
        out[t] = {
            "admitted_bytes": metrics.get(mt.labeled(mt.C_ADMIT_BYTES,
                                                     tenant=t)),
            "admit_waits": wait.get("count", 0),
            "admit_wait_ms_sum": wait.get("sum", 0.0),
            "admit_wait_ms_max": wait.get("max", 0.0),
            "cross_grants": _hist_snapshot(
                metrics, mt.labeled(mt.H_ADMIT_CROSS, tenant=t)),
            "reads": metrics.get(mt.labeled("shuffle.read.count",
                                            tenant=t))}
    return out


class _WhaleDrain:
    """Settles the whale's flooded device-sink reads after the first, in
    the order they complete (each holds its reservation until then): the
    last is drained to the host through ``host_view()`` and checked
    against main's digests, the others closed. Runs on its own thread;
    an error is kept and raised by :meth:`join`."""

    def __init__(self, futures, main_digests: dict):
        import threading
        self.pending = list(futures)
        self.main_digests = main_digests
        self.error = None
        self.last_done = 0.0
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        try:
            deadline = time.monotonic() + TENANCY_DEADLINE_S
            while self.pending:
                ready = [f for f in self.pending if f.done()]
                if not ready:
                    if time.monotonic() > deadline:
                        raise AssertionError("a whale read never completed")
                    time.sleep(0.002)
                    continue
                for f in ready:
                    self.pending.remove(f)
                    res = f.result()
                    self.last_done = time.perf_counter()
                    if self.pending:
                        res.close()
                        continue
                    view = res.host_view()
                    parts = [view.partition(r) for r in range(PARTITIONS)]
                    if partition_digests(parts) != self.main_digests:
                        raise AssertionError("the whale's last read differs "
                                             "from main's")
        except BaseException as e:
            self.error = e

    def start(self) -> "_WhaleDrain":
        self.thread.start()
        return self

    def join(self) -> None:
        self.thread.join(TENANCY_DEADLINE_S)
        if self.thread.is_alive():
            raise AssertionError("the whale drain did not finish")
        if self.error is not None:
            raise self.error


def tenancy_cell(dev, name: str, conf_extra: dict, minnows: list,
                 whale, main_digests: dict, cap: int,
                 contend: bool = False) -> dict:
    """One cell: the minnows' MINNOW_ROUNDS rounds of ``read_async`` (all
    MINNOWS at once, then the next round), after the whale's
    WHALE_FLOOD device-sink ``read_async`` reads of its one shuffle when
    ``whale`` is given: the flood's first read holds its reservation
    (one whale footprint, the cap) until round 1's minnows are all
    deferred behind the three queued whale reads, then is drained and
    checked against main's digests; the rest settle in completion order
    (:class:`_WhaleDrain`). With ``contend``, one more host-sink whale
    read and the minnows are then submitted together, so that their packs
    overlap (``pack_share_contended``: the ``_pack_share`` answers of
    that window). Every result is held against its oracle. Returns the
    latencies, the admission figures and the launch counts against the
    launch rule."""
    import gc

    import torch
    from sparkucx_tpu_torch import backend, connect
    conf = {**TENANCY_CONF, PFX + "a2a.maxBytesInFlight": str(cap),
            **conf_extra}
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        mgr = svc.manager
        hs = [write_maps(svc, 500 + i, m["keys"], m["values"], MINNOW_MAPS,
                         tenant="minnow") for i, m in enumerate(minnows)]
        wh = None
        if whale is not None:
            wh = write_maps(svc, 600, whale[0], whale[1], MAPS,
                            tenant="whale")
            svc.read(wh, sink="device").close()        # warm, not counted
        for h, m in zip(hs[-2:], minnows[-2:]):        # warm both kinds
            svc.read(h, combine="sum" if m["combine"] else None)
        torch.cuda.synchronize(dev)
        staged = svc.node.pool.stats()["in_use_bytes"]
        svc.node.pool.reset_peak_bytes()
        backend.reset_launch_counts()
        lat, s2r, queued, walls = [], [], [], []
        drain, whale_wall_ms, first_whale = None, None, {}
        with _TenancyTap(mgr) as tap, KernelCapture() as cap_k:
            t_flood = time.perf_counter()
            if wh is not None:
                wfuts = [svc.read_async(wh, sink="device")
                         for _ in range(WHALE_FLOOD)]
                q = mgr._admit_queue
                _wait_for(lambda: q.depth() == WHALE_FLOOD - 1
                          and any(f.done() for f in wfuts),
                          "the whale flood in admission")
                time.sleep(0.2)        # the queued whale reads poll first
                w0 = next(f for f in wfuts if f.done())
                drain = _WhaleDrain([f for f in wfuts if f is not w0],
                                    main_digests)
            for rnd in range(MINNOW_ROUNDS):
                t_sub, done_at, futs = {}, {}, []
                for i, (h, m) in enumerate(zip(hs, minnows)):
                    t_sub[i] = time.perf_counter()
                    f = svc.read_async(
                        h, combine="sum" if m["combine"] else None)
                    f.add_done_callback(
                        lambda _f, i=i: done_at.__setitem__(
                            i, time.perf_counter()))
                    futs.append(f)
                if rnd == 0 and wh is not None:
                    q = mgr._admit_queue
                    _wait_for(lambda: q.depth() == WHALE_FLOOD - 1 + MINNOWS,
                              "round 1's minnows queued behind the flood")
                    first_whale["queue_depth"] = q.depth()
                    first_whale["minnows_queued_ms"] = \
                        (time.perf_counter() - t_flood) * 1e3
                    drain.start()
                    view = w0.result().host_view()
                    parts = [view.partition(r) for r in range(PARTITIONS)]
                    first_whale["served_ms"] = \
                        (time.perf_counter() - t_flood) * 1e3
                    if partition_digests(parts) != main_digests:
                        raise AssertionError(f"{name}: the whale's first "
                                             f"read differs from main's")
                    del parts, view
                results = [f.result(timeout=TENANCY_DEADLINE_S)
                           for f in futs]
                for i, f in enumerate(futs):
                    lat.append(f.queued_ms + f.wall_ms)
                    queued.append(f.queued_ms)
                    walls.append(f.wall_ms)
                    s2r.append((done_at[i] - t_sub[i]) * 1e3)
                for i, (res, m) in enumerate(zip(results, minnows)):
                    check_minnow(res, m, f"{name} round {rnd} minnow {i}")
                del results
            if drain is not None:
                drain.join()
                whale_wall_ms = (drain.last_done - t_flood) * 1e3
            mark = len(tap.shares)
            if contend:
                fw = svc.read_async(wh)
                # the minnows start while the whale read packs
                _wait_for(lambda: fw.done() or mgr._packing.get("whale"),
                          "the contended whale read's pack")
                futs = [svc.read_async(h, combine="sum" if m["combine"]
                                       else None)
                        for h, m in zip(hs, minnows)]
                for i, (f, m) in enumerate(zip(futs, minnows)):
                    check_minnow(f.result(timeout=TENANCY_DEADLINE_S), m,
                                 f"{name} contended minnow {i}")
                view = fw.result(timeout=TENANCY_DEADLINE_S)
                parts = [view.partition(r) for r in range(PARTITIONS)]
                if partition_digests(parts) != main_digests:
                    raise AssertionError(f"{name}: the contended whale read "
                                         f"differs from main's")
                del parts, view, futs
            torch.cuda.synchronize(dev)
            got = _check_rule(name, tap)
            checks = cap_k.check(name)
        gc.collect()
        pool = svc.node.pool.stats()
        if not (mgr._inflight_bytes == 0 and not mgr._admit_queue
                and mgr._inflight_by_tenant == {}
                and pool["in_use_bytes"] == staged):
            raise AssertionError(
                f"{name}: in flight {mgr._inflight_bytes} B, queue "
                f"{len(mgr._admit_queue)}, pool {pool['in_use_bytes']} B "
                f"in use against the writers' {staged}")
        per_tenant = _tenant_metrics(svc.node.metrics, ("minnow", "whale"))
        shares, contended = {}, {}
        for i, (tenant, share, contending) in enumerate(tap.shares):
            key = f"{tenant} with {'+'.join(contending)}"
            shares.setdefault(key, set()).add(share)
            if i >= mark:
                contended.setdefault(key, set()).add(share)
        out = {"phase": name, "minnows": MINNOWS, "rounds": MINNOW_ROUNDS,
               "minnow_records": MINNOW_RECORDS, "cap": cap,
               "fair_share": conf.get(PFX + "tenant.fairShare", "true"),
               "minnow_reads": len(lat),
               "minnow_p50_ms": _pct(lat, 50), "minnow_p99_ms": _pct(lat, 99),
               "minnow_wall_p50_ms": _pct(walls, 50),
               "minnow_wall_p99_ms": _pct(walls, 99),
               "minnow_queued_p50_ms": _pct(queued, 50),
               "minnow_queued_p99_ms": _pct(queued, 99),
               "submit_to_result_p50_ms": _pct(s2r, 50),
               "submit_to_result_p99_ms": _pct(s2r, 99),
               "whale_reads": WHALE_FLOOD if wh is not None else 0,
               "whale_flood_to_last_ms": whale_wall_ms,
               "first_whale": first_whale, "per_tenant": per_tenant,
               "pack_share": {k: sorted(v) for k, v in shares.items()},
               "pack_share_contended": {k: sorted(v)
                                        for k, v in contended.items()},
               "pack_workers": mgr._pack_workers(),
               "pool_peak_bytes": pool["peak_bytes"],
               "pool_in_use_bytes": pool["in_use_bytes"],
               "staged_bytes": staged, "launches": got,
               "kernel_checks": checks,
               "impls": sorted({r.impl for r in tap.reports}), "ok": True}
    return out


def tenancy_overrides(dev, minnows: list) -> dict:
    """The per-tenant overrides at minnow size on one node each: tenant
    ``a`` at ``integrity.verify=full`` and ``b`` at ``off``, read back to
    back; tenant ``d`` with ``replayBudget=0`` under an armed exchange
    fault raises without a replay, the default tenant's read replays
    once; then tenant ``c`` with ``waveDepth=1`` beside the default
    depth 2 in a waved device-sink ordered read (``dense``, 4 waves: the
    merge in its fold): each wave packs only after the previous one was
    forced, and it reserves less."""
    import torch
    from sparkucx_tpu_torch import backend, connect
    from sparkucx_tpu_torch.ops import segmented as sg
    from sparkucx_tpu_torch.runtime.failures import InjectedFault
    m0 = minnows[0]
    out = {"phase": "tenancy_overrides"}
    conf = {**TENANCY_CONF, PFX + "failure.policy": "replay",
            PFX + "tenant.a.integrity.verify": "full",
            PFX + "tenant.b.integrity.verify": "off",
            PFX + "tenant.d.replayBudget": "0"}
    backend.reset_launch_counts()
    with connect(conf, num_shards=SHARDS, use_env=False) as svc, \
            _TenancyTap(svc.manager) as tap:
        for sid, tenant in ((700, "a"), (701, "b")):
            h = write_maps(svc, sid, m0["keys"], m0["values"], MINNOW_MAPS,
                           tenant=tenant)
            t0 = time.perf_counter()
            res = svc.read(h)
            ms = (time.perf_counter() - t0) * 1e3
            check_minnow(res, m0, f"overrides tenant {tenant}")
            rep = svc.report(sid)
            out[f"tenant_{tenant}"] = {"integrity": rep.integrity,
                                       "integrity_bytes": rep.integrity_bytes,
                                       "read_ms": ms}
        staged = int(m0["keys"].nbytes + m0["values"].nbytes)
        a, b = out["tenant_a"], out["tenant_b"]
        if not (a["integrity"] == "full" and a["integrity_bytes"] > staged
                and b["integrity"] == "" and b["integrity_bytes"] == 0):
            raise AssertionError(f"overrides: integrity levels {a} {b}")
        hd = write_maps(svc, 702, m0["keys"], m0["values"], MINNOW_MAPS,
                        tenant="d")
        hn = write_maps(svc, 703, m0["keys"], m0["values"], MINNOW_MAPS)
        svc.node.faults.arm("exchange", fail_count=1)
        try:
            svc.read(hd)
            raised = None
        except InjectedFault as e:
            raised = f"{type(e).__name__}: {e}"[:200]
        svc.node.faults.arm("exchange", fail_count=1)
        check_minnow(svc.read(hn), m0, "overrides default tenant replay")
        budgets = [svc.manager._replay_budget_for(s) for s in (702, 703)]
        out["tenant_d"] = {"raised": raised,
                           "replays": svc.report(702).replays,
                           "budget": budgets[0]}
        out["default"] = {"replays": svc.report(703).replays,
                          "budget": budgets[1]}
        if not (raised and out["tenant_d"]["replays"] == 0
                and out["default"]["replays"] == 1):
            raise AssertionError(f"overrides: replay budgets {out}")
        out["launches"] = _check_rule("tenancy_overrides", tap)
    backend.reset_launch_counts()
    k, v = m0["keys"], m0["values"]
    bounds = terasort_bounds(k)
    wave_rows = MINNOW_RECORDS // SHARDS // 4
    wconf = {PFX + "a2a.impl": "dense", PFX + "a2a.waveRows": str(wave_rows),
             PFX + "a2a.waveDepth": "2", PFX + "tenant.c.waveDepth": "1",
             PFX + "a2a.maxBytesInFlight": "64g"}
    merges = 0
    with connect(wconf, num_shards=SHARDS, use_env=False) as svc:
        for sid, tenant in ((710, "c"), (711, None)):
            h = write_maps(svc, sid, k, v, MINNOW_MAPS, "range", bounds,
                           tenant=tenant)
            torch.cuda.synchronize(dev)
            res = svc.read(h, ordered=True, sink="device")
            reserved = svc.manager._inflight_bytes
            rep = svc.report(sid)
            nrows, ksum, unsorted = res.consume(_key_checksum)
            if (int(nrows), int(ksum), bool(unsorted)) != (
                    k.shape[0], int(k.sum()), False) or rep.waves != 4:
                raise AssertionError(f"overrides: waved read of tenant "
                                     f"{tenant}: {int(nrows)} rows, waves "
                                     f"{rep.waves}")
            tl = rep.wave_timeline
            serial = all(tl[i + 1]["pack_start_ms"] >= tl[i]["forced_ms"]
                         for i in range(len(tl) - 1))
            merges += rep.waves - 1
            out[f"waved_{tenant or 'default'}"] = {
                "tenant": rep.tenant, "waves": rep.waves,
                "reserved": reserved, "serial_waves": serial,
                "merge_ms": rep.merge_ms, "hidden_ms":
                rep.wave_pack_hidden_ms}
    c, d = out["waved_c"], out["waved_default"]
    if not (c["serial_waves"] and c["reserved"] < d["reserved"]):
        raise AssertionError(f"overrides: waveDepth=1 not honoured: {c} "
                             f"against {d}")
    got = backend.launch_counts().get(sg.MERGE_KERNEL_NAME, 0)
    if got != merges:
        raise AssertionError(f"overrides: merge launched {got} times, the "
                             f"fold's steps {merges}")
    out["launches"][sg.MERGE_KERNEL_NAME] = got
    out["ok"] = True
    return out


def tenancy_quota(dev, minnows: list, minnow_footprint: int) -> dict:
    """Tenant ``hog`` with a ``maxBytesInFlight`` of one of its reads:
    three device-sink ``read_async`` reads of its shuffle, the first
    granted and held, two deferred on its own quota; a ``normal``
    tenant's read submitted after them is granted past the blocked hog
    head and completes while the hog's first read still holds; then the
    hog's reads complete one by one. Every result against the oracle."""
    from sparkucx_tpu_torch import connect
    from sparkucx_tpu_torch.utils import metrics as mt
    m0 = minnows[0]
    conf = {**TENANCY_CONF, PFX + "a2a.maxBytesInFlight": "64g",
            PFX + "tenant.hog.maxBytesInFlight": str(minnow_footprint)}
    out = {"phase": "tenancy_quota", "hog_quota": minnow_footprint}
    from sparkucx_tpu_torch import backend
    backend.reset_launch_counts()
    with connect(conf, num_shards=SHARDS, use_env=False) as svc, \
            _TenancyTap(svc.manager) as tap:
        mgr = svc.manager
        hh = write_maps(svc, 720, m0["keys"], m0["values"], MINNOW_MAPS,
                        tenant="hog")
        hn = write_maps(svc, 721, m0["keys"], m0["values"], MINNOW_MAPS,
                        tenant="normal")
        check_minnow(svc.read(hn), m0, "quota warm")
        hogs = [svc.read_async(hh, sink="device") for _ in range(3)]
        q = mgr._admit_queue
        _wait_for(lambda: q.depth() == 2 and any(f.done() for f in hogs),
                  "two hog reads deferred on the hog's quota")
        t0 = time.perf_counter()
        fn = svc.read_async(hn)
        res = fn.result(timeout=TENANCY_DEADLINE_S)
        out["normal_ms"] = (time.perf_counter() - t0) * 1e3
        out["queue_at_normal"] = q.depth()
        out["hog_held_at_normal"] = mgr._inflight_by_tenant.get("hog", 0)
        check_minnow(res, m0, "quota normal")
        if out["queue_at_normal"] != 2 or not out["hog_held_at_normal"]:
            raise AssertionError(f"quota: the normal read was not granted "
                                 f"past the blocked hog head: {out}")
        left = list(hogs)
        while left:
            _wait_for(lambda: any(f.done() for f in left), "a hog read")
            f = next(f for f in left if f.done())
            left.remove(f)
            check_minnow(f.result().host_view(), m0, "quota hog")
        out["per_tenant"] = _tenant_metrics(svc.node.metrics,
                                            ("hog", "normal"))
        cross = _hist_snapshot(svc.node.metrics,
                               mt.labeled(mt.H_ADMIT_CROSS, tenant="normal"))
        if not (mgr._inflight_bytes == 0 and not q
                and cross.get("max", 0.0) == 0.0):
            raise AssertionError(f"quota: end state {mgr._inflight_bytes} B "
                                 f"in flight, queue {len(q)}, normal's "
                                 f"cross grants {cross}")
        out["launches"] = _check_rule("tenancy_quota", tap)
    out["ok"] = True
    return out


def tenancy_phase(dev, main_digests: dict) -> dict:
    """The tenancy plane on the card: tenancy_solo, tenancy_fair and
    tenancy_fifo (:func:`tenancy_cell`; the cap is one whale read's
    footprint, measured first), tenancy_overrides and tenancy_quota.
    Asserts the grant order through each minnow ticket's
    ``shuffle.admit.cross_grants{tenant=minnow}``: at most
    FAIR_CROSS_BOUND under DRR, exactly FIFO_CROSS for each of round 1's
    minnows under FIFO (the only deferred minnows there)."""
    import torch
    from sparkucx_tpu_torch import connect
    from sparkucx_tpu_torch.ops import ragged_a2a as ra
    from sparkucx_tpu_torch.ops import segmented as sg
    from sparkucx_tpu_torch.runtime.node import _empty_host_cache
    t = time.perf_counter()
    keys, values = make_records(RECORDS, zipf=False, seed=SEED)
    minnows = minnow_data()
    gen_s = time.perf_counter() - t
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    # one whale read's footprint, and one minnow read's
    with connect(TENANCY_CONF, num_shards=SHARDS, use_env=False) as svc:
        wh = write_maps(svc, 600, keys, values, MAPS, tenant="whale")
        svc.read(wh, sink="device").close()
        whale_fp = one_read_footprint(svc.report(600), RECORD_WORDS)
        hm = write_maps(svc, 601, minnows[0]["keys"], minnows[0]["values"],
                        MINNOW_MAPS, tenant="minnow")
        svc.read(hm)
        minnow_fp = one_read_footprint(svc.report(601), RECORD_WORDS)
    out = {"gen_s": gen_s, "whale_footprint": whale_fp,
           "minnow_footprint": minnow_fp}
    cells = {"tenancy_solo": ({}, None),
             "tenancy_fair": ({}, (keys, values)),
             "tenancy_fifo": ({PFX + "tenant.fairShare": "false"},
                              (keys, values))}
    for name, (extra, whale) in cells.items():
        out[name] = tenancy_cell(dev, name, extra, minnows, whale,
                                 main_digests, whale_fp,
                                 contend=name == "tenancy_fair")
        _empty_host_cache()
    del keys, values
    solo = out["tenancy_solo"]["minnow_p99_ms"]
    for name in ("tenancy_fair", "tenancy_fifo"):
        out[name]["p99_over_solo"] = out[name]["minnow_p99_ms"] / solo
        out[name]["reference_cpu_claim"] = 1.8
    fair = out["tenancy_fair"]["per_tenant"]["minnow"]["cross_grants"]
    fifo = out["tenancy_fifo"]["per_tenant"]["minnow"]["cross_grants"]
    if not (fair.get("count", 0) >= MINNOWS
            and fair.get("max", 0.0) <= FAIR_CROSS_BOUND):
        raise AssertionError(f"tenancy_fair: a minnow waited through more "
                             f"than {FAIR_CROSS_BOUND} whale grants: {fair}")
    if not (fifo.get("count") == MINNOWS
            and fifo.get("min") == fifo.get("max") == FIFO_CROSS):
        raise AssertionError(f"tenancy_fifo: round 1's minnows must each "
                             f"wait through {FIFO_CROSS} whale grants: "
                             f"{fifo}")
    out["tenancy_overrides"] = tenancy_overrides(dev, minnows)
    out["tenancy_quota"] = tenancy_quota(dev, minnows, minnow_fp)
    torch.cuda.synchronize(dev)
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    launches = {ra.KERNEL_NAME: 0, sg.KERNEL_NAME: 0,
                sg.MERGE_KERNEL_NAME: 0}
    for name in (*cells, "tenancy_overrides", "tenancy_quota"):
        for kname, n in out[name]["launches"].items():
            launches[kname] += n
    out["tenancy_launches"] = launches
    return out


def dist_async(ctx, dev) -> dict:
    """dist_async in the two-worker world: every worker submits the same
    six ``read_async`` reads of two tenants (``lo`` normal, ``hi`` high),
    minnow size and shape, in the same order, on ``tenant.asyncWorkers=
    4``; each result against the oracle (this worker's partitions), the
    execution order (the reports' exchange sequence numbers) against the
    concatenated agreed batch orders (``tenancy.agreed_submission_order``
    wrapped), ``async_workers`` on every report, the turnstile's wait
    histogram. Every future has a deadline."""
    from sparkucx_tpu_torch.cluster import my_maps
    from sparkucx_tpu_torch.shuffle import tenancy
    from sparkucx_tpu_torch.utils import metrics as mt
    k, v = make_records(MINNOW_RECORDS, zipf=False, seed=SEED + 30)
    mine = my_maps(ctx, MINNOW_MAPS)
    orders, real = [], tenancy.agreed_submission_order

    def spy(pending, weight_of):
        got = real(pending, weight_of)
        orders.append([int(s) for s in got])
        return got

    tenancy.agreed_submission_order = spy
    try:
        with ctx.connect({PFX + "tenant.hi.priority": "high",
                          PFX + "tenant.asyncWorkers": "4"}) as svc:
            per = -(-k.shape[0] // MINNOW_MAPS)
            hs = []
            for i, tenant in enumerate(DIST_ASYNC_TENANTS):
                h = svc.register_shuffle(90 + i, MINNOW_MAPS, PARTITIONS,
                                         tenant=tenant)
                for m in mine:
                    svc.write(h, m, k[m * per:(m + 1) * per],
                              v[m * per:(m + 1) * per])
                hs.append(h)
            t0 = time.perf_counter()
            futs = [svc.read_async(h) for h in hs]
            results = [f.result(timeout=TENANCY_DEADLINE_S) for f in futs]
            wall_ms = (time.perf_counter() - t0) * 1e3
            reps = [svc.report(h.shuffle_id) for h in hs]
            local = []
            for res in results:
                parts = dict(res.partitions())
                check_against_oracle(parts, k, v, PARTITIONS)
                local.append(sorted(parts))
            if any(p != local[0] for p in local):
                raise AssertionError("dist_async: the reads hold other "
                                     "partitions")
            ran = sorted(range(len(hs)), key=lambda i: reps[i]._seq)
            m = svc.node.metrics
            out = {"wall_ms": wall_ms, "orders": list(orders), "ran": ran,
                   "partitions": local[0],
                   "async_workers": [r.async_workers for r in reps],
                   "tenants": [r.tenant for r in reps],
                   "impls": [r.impl for r in reps],
                   "read_wall_ms": [f.wall_ms for f in futs],
                   "queued_ms": [f.queued_ms for f in futs],
                   "turnstile_wait_ms": _hist_snapshot(
                       m, mt.H_TURNSTILE_WAIT),
                   "turnstile_depth": m.get_gauge(mt.G_TURNSTILE_DEPTH),
                   "rounds": {topic: m.get(mt.labeled(mt.C_AGREE_ROUNDS,
                                                      topic=topic))
                              for topic in ("async.batch", "async.order")}}
            del results
            for h in hs:
                svc.unregister_shuffle(h.shuffle_id)
    finally:
        tenancy.agreed_submission_order = real
    return out


# -- the telemetry plane: the tracer's cost, the device trace, the device-
# memory sampler, the snapshot and the flight recorder (utils/trace.py,
# utils/export.py, utils/history.py, runtime/devmon.py) ----------------------
TELEMETRY_READS = 5            # warm reads a median is taken over
# the span names of one plain read (submit to result), as the JAX
# package's manager names them (tests/test_torch_trace.py holds the port
# to it read mode by read mode)
PLAIN_READ_SPANS = {"shuffle.barrier": 1, "shuffle.plan": 2,
                    "shuffle.verify": 1,
                    "shuffle.pack": 1, "shuffle.dispatch": 1,
                    "shuffle.submit": 1, "shuffle.exchange.wait": 1,
                    "shuffle.result": 1, "shuffle.settle": 1,
                    "shuffle.exchange": 1}
SEGMENT_MOVE_SYMBOL = "ragged_segment_copy"   # csrc/ragged_a2a.cu's kernel
TELEMETRY_FAULT_DELAY_MS = 1500.0


def _timed_reads(svc, h, n: int) -> list:
    """``n`` reads of ``h`` (the read and its device work, no views):
    their walls in ms."""
    import torch
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        svc.read(h)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def _read_breakdown(spans, trace_id: str) -> dict:
    """One read's ms by span name (the spans tagged with its trace id,
    and the untagged completion wait and result assembly inside its
    wall) and each as a share of the wall (``shuffle.exchange``)."""
    wall = next(s for s in spans if s.name == "shuffle.exchange"
                and s.attrs.get("trace") == trace_id)
    lo, hi = wall.start_us, wall.start_us + wall.dur_us
    ms = {}
    for s in spans:
        inside = lo <= s.start_us and s.start_us + s.dur_us <= hi
        if s.attrs.get("trace") == trace_id or (
                inside and s.name in ("shuffle.exchange.wait",
                                      "shuffle.result")):
            ms[s.name] = ms.get(s.name, 0.0) + s.dur_ms
    return {"wall_ms": wall.dur_ms, "ms": ms,
            "share": {k: v / wall.dur_ms for k, v in ms.items()
                      if k != "shuffle.exchange"}}


def telemetry_trace(dev, svc, h) -> dict:
    """(a) and (b) of the telemetry phase on main's committed shuffle:
    the warm read's median wall with the tracer off and on (5 reads
    each, in turns); each traced read's span names against the
    reference's (plus the port's staged ``shuffle.verify``) and their
    trace id; the span summary and the per-span breakdown; then one
    read inside ``tracer.device_trace``
    with the tracer off (the profiler makes its spans live), whose
    Chrome trace must hold the segment move's kernel, at most as often
    as its launch counter moved, each launched from inside a
    ``shuffle.dispatch`` range."""
    import torch
    from sparkucx_tpu_torch import backend
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME
    tracer = svc.node.tracer
    out = {}
    svc.read(h)                      # warm (not counted, not timed)
    backend.reset_launch_counts()
    off, on, breakdowns = [], [], []
    # in turns (off, on, on, off, ...), so drift does not favour a side;
    # turning it on is what trace.enabled=true does at node start
    for i in range(2 * TELEMETRY_READS):
        traced = (i % 4) in (1, 2)
        tracer.enabled = traced
        tracer.clear()
        wall = _timed_reads(svc, h, 1)
        if not traced:
            off += wall
            continue
        on += wall
        rep = svc.report(h.shuffle_id)
        spans = tracer.spans()
        names = {}
        for s in spans:
            names[s.name] = names.get(s.name, 0) + 1
        want = dict(PLAIN_READ_SPANS)
        want["shuffle.dispatch"] += rep.retries
        want["shuffle.exchange.wait"] += rep.retries
        if names != want:
            raise AssertionError(f"telemetry: a traced read's spans "
                                 f"{names}, the reference's {want}")
        tagged = {s.attrs["trace"] for s in spans if "trace" in s.attrs}
        if tagged != {rep.trace_id}:
            raise AssertionError(f"telemetry: spans tagged {tagged}, the "
                                 f"read is {rep.trace_id}")
        breakdowns.append(_read_breakdown(spans, rep.trace_id))
    tracer.enabled = True
    launches = counted(KERNEL_NAME)
    summary = {k: {"count": v["count"], "total_ms": v["total_ms"]}
               for k, v in tracer.summary().items()}
    if tracer.dropped:
        raise AssertionError(f"telemetry: the tracer dropped "
                             f"{tracer.dropped} spans")
    names = sorted(breakdowns[0]["ms"])
    out.update(
        reads=TELEMETRY_READS, tracer_off_ms=off, tracer_on_ms=on,
        tracer_off_median_ms=float(np.median(off)),
        tracer_on_median_ms=float(np.median(on)),
        span_summary_last_read=summary,
        breakdown_median_ms={k: float(np.median(
            [b["ms"].get(k, 0.0) for b in breakdowns])) for k in names},
        breakdown_median_share={k: float(np.median(
            [b["share"].get(k, 0.0) for b in breakdowns]))
            for k in names if k != "shuffle.exchange"},
        wall_median_ms=float(np.median([b["wall_ms"]
                                        for b in breakdowns])),
        traced_launches=launches, trace_id=rep.trace_id)
    # (b) the device trace: spans as record_function ranges beside the
    # kernels, live under the profiler with the tracer off
    logdir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        tracer.enabled = False
        tracer.clear()
        before = backend.launch_counts().get(KERNEL_NAME, 0)
        with tracer.device_trace(logdir):
            time.sleep(PROFILER_LEAD_S)
            svc.read(h)
            torch.cuda.synchronize(dev)
        delta = backend.launch_counts().get(KERNEL_NAME, 0) - before
        path = tracer.device_trace_path
        if not path:
            raise AssertionError("telemetry: the device trace did not run")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        trace_bytes = os.path.getsize(path)
    finally:
        tracer.enabled = False
        tracer.clear()
        shutil.rmtree(logdir, ignore_errors=True)
    xs = [e for e in events if e.get("ph") == "X"]
    kernels = [e for e in xs if SEGMENT_MOVE_SYMBOL in str(e.get("name"))
               and e.get("cat") == "kernel"]
    dispatch = [(e["ts"], e["ts"] + e["dur"]) for e in xs
                if e.get("name") == "shuffle.dispatch"
                and e.get("cat") == "user_annotation"]
    by_corr = {}
    for e in xs:
        c = (e.get("args") or {}).get("correlation")
        if c is not None and e.get("cat") != "kernel":
            by_corr.setdefault(c, []).append(e)
    if not (1 <= len(kernels) <= delta) or not dispatch:
        raise AssertionError(
            f"telemetry: the device trace holds {len(kernels)} segment "
            f"moves and {len(dispatch)} dispatch ranges; the counter "
            f"moved {delta}")
    launch_ts = []
    for k in kernels:
        hosts = by_corr.get(k["args"]["correlation"], [])
        if not hosts:
            raise AssertionError(f"telemetry: no host launch for kernel "
                                 f"{k['name'][:60]}")
        ts = hosts[0]["ts"]
        if not any(lo <= ts <= hi for lo, hi in dispatch):
            raise AssertionError(f"telemetry: a segment move launched at "
                                 f"{ts} outside every shuffle.dispatch "
                                 f"range {dispatch}")
        launch_ts.append(ts)
    out["device_trace"] = {
        "segment_moves": len(kernels), "counter_delta": delta,
        "dispatch_ranges": len(dispatch),
        "launch_api": sorted({hosts["name"] for k in kernels
                              for hosts in by_corr[k["args"]
                                                   ["correlation"]]}),
        "kernel_device_ms": [k["dur"] / 1e3 for k in kernels],
        "events": len(events), "trace_bytes": trace_bytes}
    return out


def telemetry_devmon(dev, keys, values, history_dir: str) -> dict:
    """(c) and (d) of the telemetry phase: one waved device-sink read of
    main's records at WAVE_CONF under ``devmon.enabled`` (20 ms) and the
    flight recorder (which owns the in-flight trace the samples carry),
    ``history.dir`` with one-second windows; then the snapshot in both
    formats and the history frames against the registry."""
    import torch
    from sparkucx_tpu_torch import connect
    from sparkucx_tpu_torch.utils.export import validate_exposition
    from sparkucx_tpu_torch.utils.history import load_history_file
    from sparkucx_tpu_torch.utils.metrics import (G_HBM_IN_USE, G_HBM_LIMIT,
                                                  G_HBM_PEAK, labeled)
    conf = {**WAVE_CONF, PFX + "devmon.enabled": "true",
            PFX + "devmon.intervalMs": "20",
            PFX + "flightRecorder.enabled": "true",
            PFX + "flightRecorder.dir": os.path.join(history_dir, "flight"),
            PFX + "history.dir": history_dir,
            PFX + "history.windowSecs": "1"}
    out = {}
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        node = svc.node
        node.history.roll()          # the first window opens here
        node.tracer.enabled = False  # the recorder's spans are not timed
        h = write_maps(svc, 701, keys, values, MAPS)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = svc.read(h, sink="device")
        res.consume(lambda carry, rows, tot: None)
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
        rep = svc.report(701)
        max_alloc = torch.cuda.max_memory_allocated(dev)
        if rep.waves < 2 or rep.sink != "device":
            raise AssertionError(f"telemetry_devmon: {rep.waves} waves on "
                                 f"the {rep.sink} sink")
        node.devmon.sample_once()
        samples = node.devmon.samples()
        stamped = [s for s in samples if s["trace"] == rep.trace_id]
        nulls = [d for s in samples for d in s["devices"]
                 if None in (d["in_use"], d["limit"], d["peak"])]
        g = node.metrics.gauges()
        key = {n: labeled(n, device=dev.index or 0)
               for n in (G_HBM_IN_USE, G_HBM_LIMIT, G_HBM_PEAK)}
        in_use, limit, peak = (g.get(key[n]) for n in (
            G_HBM_IN_USE, G_HBM_LIMIT, G_HBM_PEAK))
        total = torch.cuda.get_device_properties(dev).total_memory
        if not stamped or nulls or in_use is None or limit is None \
                or peak is None or not (in_use <= limit == total) \
                or peak < in_use \
                or not {"pool.in_use_bytes", "pool.peak_bytes"} <= set(g):
            raise AssertionError(
                f"telemetry_devmon: {len(stamped)} samples of "
                f"{len(samples)} stamped {rep.trace_id}, {len(nulls)} "
                f"null device fields, in_use {in_use} limit {limit} "
                f"(card {total}) peak {peak}, gauges {sorted(g)}")
        out["devmon"] = {
            "samples": len(samples), "stamped": len(stamped),
            "read_wall_ms": wall, "waves": rep.waves,
            "in_use": in_use, "limit": limit,
            "peak_during_read": max(d["peak"] for s in stamped
                                    for d in s["devices"]),
            "max_memory_allocated": max_alloc,
            "pool_peak_bytes": g["pool.peak_bytes"]}
        # (d) the snapshot in both formats
        svc.unregister_shuffle(701)
        text = svc.stats("prometheus")
        validate_exposition(text)
        doc = svc.stats("json")
        reads = doc["counters"]["shuffle.read.count"]
        waits = doc["histograms"]["shuffle.read.wait_ms"]["count"]
        if not reads == waits == 1:
            raise AssertionError(f"telemetry_snapshot: {reads} reads, "
                                 f"{waits} waits observed")
        # the last window: the dumper stops first, so no roll races it
        svc._dumper.stop()
        svc._dumper = None
        node.history.roll()
        counters = node.metrics.snapshot()
    frames = load_history_file(os.path.join(history_dir,
                                            "history_p0.jsonl"))
    summed = {}
    for f in frames:
        for k, v in f["counters"].items():
            summed[k] = summed.get(k, 0.0) + v
    # the sampler counts on its own thread from node start, before the
    # first window opened
    want = {k: v for k, v in counters.items() if not k.startswith("devmon")}
    got = {k: v for k, v in summed.items() if not k.startswith("devmon")}
    if got != want or not frames:
        bad = sorted(k for k in set(want) | set(got)
                     if want.get(k) != got.get(k))
        raise AssertionError(f"telemetry_history: {len(frames)} frames; "
                             f"counters that do not add up: {bad[:8]}")
    out["snapshot"] = {"exposition_lines": len(text.splitlines()),
                       "json_keys": sorted(doc),
                       "reads": reads, "wait_count": waits,
                       "frames": len(frames),
                       "counters_checked": len(want)}
    return out


def telemetry_flight(dev, keys, values, flight_dir: str) -> dict:
    """(e) of the telemetry phase: one read of an eighth of main's
    records under an armed ``exchange`` fault (it fires once, after a
    delay) with the flight recorder on; a postmortem taken while the
    read is in flight names the read in ``in_flight_traces`` and holds
    its spans; the read then fails typed."""
    import threading

    from sparkucx_tpu_torch import connect
    from sparkucx_tpu_torch.runtime.failures import InjectedFault
    n = RECORDS // 8
    conf = {PFX + "a2a.impl": "pallas",
            PFX + "flightRecorder.enabled": "true",
            PFX + "flightRecorder.dir": flight_dir,
            PFX + "fault.exchange.failCount": "1",
            PFX + "fault.exchange.delayMs": str(TELEMETRY_FAULT_DELAY_MS)}
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        node = svc.node
        h = write_maps(svc, 702, keys[:n], values[:n], MAPS)
        box = {}

        def take_postmortem():
            deadline = time.monotonic() + 60.0
            while node.flight.current_trace() is None:
                if time.monotonic() > deadline:
                    return
                time.sleep(0.005)
            time.sleep(TELEMETRY_FAULT_DELAY_MS / 4e3)
            box["path"] = node.flight.dump("telemetry: armed exchange "
                                           "fault in flight")

        th = threading.Thread(target=take_postmortem)
        th.start()
        try:
            svc.read(h)
            raise AssertionError("telemetry_flight: the armed read passed")
        except InjectedFault as e:
            err = f"{type(e).__name__}: {e}"
        th.join(timeout=60)
        rep = svc.report(702)
        with open(box["path"]) as f:
            doc = json.load(f)
        fault = [e for e in doc["events"] if e["kind"] == "fault"]
    if doc["in_flight_traces"] != [rep.trace_id] or not doc["spans"] \
            or not doc["trace_events"] or "wall_epoch" not in doc["anchor"]:
        raise AssertionError(
            f"telemetry_flight: in flight {doc['in_flight_traces']} "
            f"(the read {rep.trace_id}), spans {sorted(doc['spans'])}")
    return {"trace_id": rep.trace_id, "error": err,
            "in_flight_traces": doc["in_flight_traces"],
            "spans": sorted(doc["spans"]),
            "trace_events": len(doc["trace_events"]),
            "dropped_spans": doc["dropped_spans"],
            "fault_events_before_dump": len(fault)}


def telemetry_phase(dev) -> dict:
    """Phase 39 on main's records: telemetry_trace on main's committed
    shuffle (``a2a.impl=pallas``, 8 shards), telemetry_devmon (and the
    snapshot and history checks), telemetry_flight. The segment move's
    launches over the phase's reads are counted from 0."""
    import torch
    from sparkucx_tpu_torch import backend, connect
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME
    t = time.perf_counter()
    keys, values = make_records(RECORDS, zipf=False, seed=SEED)
    gen_s = time.perf_counter() - t
    root = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    try:
        backend.reset_launch_counts()
        with connect({PFX + "a2a.impl": "pallas"}, num_shards=SHARDS,
                     use_env=False) as svc:
            h = write_maps(svc, 700, keys, values, MAPS)
            tr = telemetry_trace(dev, svc, h)
            svc.unregister_shuffle(700)
        launches = counted(KERNEL_NAME)
        dm = telemetry_devmon(dev, keys, values,
                              os.path.join(root, "history"))
        fl = telemetry_flight(dev, keys, values, os.path.join(root, "fl"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"gen_s": gen_s, "telemetry_launches": launches,
            "telemetry_trace": {"phase": "telemetry_trace", **tr,
                                "ok": True},
            "telemetry_devmon": {"phase": "telemetry_devmon",
                                 **dm["devmon"], "ok": True},
            "telemetry_snapshot": {"phase": "telemetry_snapshot",
                                   **dm["snapshot"], "ok": True},
            "telemetry_flight": {"phase": "telemetry_flight", **fl,
                                 "ok": True}}


DIAGNOSIS_READS = 5            # warm traced reads the anatomy is read on
DIAGNOSIS_CORRUPT_READS = 3    # failed reads: block_corruption's critical
#                                floor (Thresholds.corruption_critical_blocks)
DIAGNOSIS_REPLAYS = 2          # exchange faults under replay: two replays
DIAGNOSIS_WATCH_S = 60.0       # the watcher drill's deadline
# the rule and grade each drill fires; tests/test_torch_doctor.py holds
# the JAX package's doctor to the same pairs on the same drills
DIAGNOSIS_DRILLS = {"corruption": ("block_corruption", "critical"),
                    "replay": ("replay_storm", "warn"),
                    "slo": ("slo_burn", "critical")}


def _ledger_check(tag: str, rep) -> dict:
    """One read's stamped ledger: conserving within the rounding of its
    stamped values (each rounded to a microsecond); returns it."""
    total = sum(rep.phases.values()) + rep.dark_ms
    tol = 1e-3 * (len(rep.phases) + 2)
    if not rep.phases or rep.anatomy_wall_ms <= 0 \
            or abs(total - rep.anatomy_wall_ms) > tol:
        raise AssertionError(f"{tag}: phases {rep.phases} + dark "
                             f"{rep.dark_ms} != wall {rep.anatomy_wall_ms}")
    return {"phases": rep.phases, "dark_ms": rep.dark_ms,
            "anatomy_wall_ms": rep.anatomy_wall_ms,
            "dark_share": rep.dark_ms / rep.anatomy_wall_ms,
            "dark_intervals": rep.dark_intervals}


def _launched(before: dict, name: str) -> int:
    """Launches of kernel ``name`` since the counts were ``before``;
    raises when there were none."""
    from sparkucx_tpu_torch import backend
    n = backend.launch_counts().get(name, 0) - before.get(name, 0)
    if n < 1:
        raise AssertionError(f"the path never launched kernel {name}")
    return n


def _fold_ms(tracer, trace_id: str, calls: int = 5) -> float:
    """The median ms of ``fold_tracer`` alone on this read's ring."""
    from sparkucx_tpu_torch.utils.anatomy import fold_tracer
    ms = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fold_tracer(tracer, trace_id)
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def diagnosis_anatomy(dev, keys, values) -> dict:
    """(1) of the diagnosis phase on main's shuffle (``pallas``, the
    tracer on): five warm plain reads, each report's ledger conserving
    with ``pack`` and ``transfer.ici`` in it, the fold's own cost; one
    combine read (the segment reduce) conserving too; the node's doctor
    then has no critical finding (the quiet case)."""
    import torch
    from sparkucx_tpu_torch import backend, connect
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME
    from sparkucx_tpu_torch.ops.segmented import KERNEL_NAME as SEG
    conf = {PFX + "a2a.impl": "pallas", PFX + "read.mergeImpl": "auto",
            PFX + "trace.enabled": "true"}
    out = {"phase": "diagnosis_anatomy", "reads": DIAGNOSIS_READS}
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        tracer = svc.node.tracer
        h = write_maps(svc, 720, keys, values, MAPS)
        svc.read(h)                  # warm
        torch.cuda.synchronize(dev)
        before = backend.launch_counts()
        reads, walls = [], []
        for i in range(DIAGNOSIS_READS):
            tracer.clear()
            walls += _timed_reads(svc, h, 1)
            rep = svc.report(720)
            led = _ledger_check(f"diagnosis read {i}", rep)
            if not {"pack", "transfer.ici"} <= set(rep.phases):
                raise AssertionError(f"diagnosis read {i}: phases "
                                     f"{sorted(rep.phases)}")
            led["fold_ms"] = _fold_ms(tracer, rep.trace_id)
            led["spans"] = len(tracer.spans())
            reads.append(led)
        plain_launches = _launched(before, KERNEL_NAME)
        tracer.clear()
        before = backend.launch_counts()
        t0 = time.perf_counter()
        res = svc.read(h, combine="sum")
        torch.cuda.synchronize(dev)
        combine_wall = (time.perf_counter() - t0) * 1e3
        del res
        rep = svc.report(720)
        comb = _ledger_check("diagnosis combine read", rep)
        comb.update(wall_ms=combine_wall, kernel=rep.kernel,
                    fold_ms=_fold_ms(tracer, rep.trace_id),
                    launches={k: _launched(before, k)
                              for k in (KERNEL_NAME, SEG)})
        findings = [f.to_dict() for f in svc.doctor()]
        critical = [f for f in findings if f["grade"] == "critical"]
        svc.unregister_shuffle(720)
    if critical:
        raise AssertionError(f"diagnosis quiet: a clean node's doctor "
                             f"found {critical}")
    names = sorted({k for r in reads for k in r["phases"]})
    out.update(
        walls_ms=walls, read_wall_median_ms=float(np.median(walls)),
        ledgers=reads, plain_launches=plain_launches, combine=comb,
        phase_median_ms={k: float(np.median([r["phases"].get(k, 0.0)
                                             for r in reads]))
                         for k in names},
        dark_median_ms=float(np.median([r["dark_ms"] for r in reads])),
        wall_median_ms=float(np.median([r["anatomy_wall_ms"]
                                        for r in reads])),
        fold_median_ms=float(np.median([r["fold_ms"] for r in reads])),
        quiet_findings=[{k: f[k] for k in ("rule", "grade", "summary")}
                        for f in findings])
    return out


def _drill_finding(tag: str, svc, rule: str, grade: str) -> dict:
    fs = [f for f in svc.doctor() if f.rule == rule]
    if [f.grade for f in fs] != [grade]:
        raise AssertionError(f"diagnosis {tag}: {rule} findings "
                             f"{[f.to_dict() for f in fs]}, want one "
                             f"{grade}")
    return fs[0].to_dict()


def diagnosis_drills(dev, keys, values, read_ms: float) -> dict:
    """(2) of the diagnosis phase, each drill on a fresh node over main's
    records (``pallas``): three reads under an armed ``corrupt.staged``
    site (each raising ``BlockCorruptionError``) fire
    ``block_corruption`` critical; a read whose exchange fails twice
    under ``failure.policy=replay`` fires ``replay_storm`` warn; reads
    under ``slo.read.p99Ms`` at half of ``read_ms`` fire ``slo_burn``
    critical, with ``health_status`` naming ``slo_fast_burn`` and
    ``slo()["burning"]`` the objective."""
    from sparkucx_tpu_torch import connect
    from sparkucx_tpu_torch.runtime.failures import BlockCorruptionError
    base = {PFX + "a2a.impl": "pallas"}
    out = {"phase": "diagnosis_drills"}
    rule, grade = DIAGNOSIS_DRILLS["corruption"]
    conf = {**base, PFX + "fault.corrupt.staged.failCount":
            str(DIAGNOSIS_CORRUPT_READS),
            PFX + "fault.corrupt.staged.offset": str(CORRUPT_OFFSET)}
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        h = write_maps(svc, 721, keys, values, MAPS)
        for _ in range(DIAGNOSIS_CORRUPT_READS):
            try:
                svc.read(h)
                raise AssertionError("diagnosis corruption: a read passed")
            except BlockCorruptionError:
                pass
        out["corruption"] = _drill_finding("corruption", svc, rule, grade)
    rule, grade = DIAGNOSIS_DRILLS["replay"]
    conf = {**base, **REPLAY_CONF,
            PFX + "fault.exchange.failCount": str(DIAGNOSIS_REPLAYS)}
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        h = write_maps(svc, 722, keys, values, MAPS)
        _timed_reads(svc, h, 1)
        if svc.report(722).replays != DIAGNOSIS_REPLAYS:
            raise AssertionError(f"diagnosis replay: "
                                 f"{svc.report(722).replays} replays")
        out["replay"] = _drill_finding("replay", svc, rule, grade)
    rule, grade = DIAGNOSIS_DRILLS["slo"]
    bound = read_ms / 2
    conf = {**base, PFX + "slo.read.p99Ms": f"{bound:.3f}",
            PFX + "history.windowSecs": "86400"}
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        node = svc.node
        h = write_maps(svc, 723, keys, values, MAPS)
        _timed_reads(svc, h, 1)      # warm, outside the graded window
        node.history.roll()
        walls = _timed_reads(svc, h, DIAGNOSIS_READS)
        node.history.roll()
        verdict = svc.slo()
        status = node.health_status()
        if verdict["burning"] != ["slo.read.p99Ms"] \
                or status["cause"] != "slo_fast_burn" or status["ok"]:
            raise AssertionError(f"diagnosis slo: burning "
                                 f"{verdict['burning']}, health {status}")
        obj = verdict["objectives"][0]
        out["slo"] = {"bound_ms": bound, "walls_ms": walls,
                      "burn_fast": obj["burn_fast"],
                      "budget": obj["budget"], "health": status,
                      "finding": _drill_finding("slo", svc, rule, grade)}
    return out


def diagnosis_watcher(dev, keys, values, root: str) -> dict:
    """(3) of the diagnosis phase: a fresh node over main's records
    (``pallas``) with the doctor watcher every 0.2 s (``captureMs`` 200)
    and the flight recorder; three reads under an armed
    ``corrupt.staged`` site make ``block_corruption`` critical, and plain
    reads go on until the watcher has captured. It captures once; its
    profile holds at least one segment-move kernel; its postmortem
    carries the finding and the doctor's ``findings``; another pass over
    the same finding captures nothing."""
    import torch
    from sparkucx_tpu_torch import connect
    from sparkucx_tpu_torch.runtime.failures import BlockCorruptionError
    conf = {PFX + "a2a.impl": "pallas",
            PFX + "fault.corrupt.staged.failCount":
            str(DIAGNOSIS_CORRUPT_READS),
            PFX + "fault.corrupt.staged.offset": str(CORRUPT_OFFSET),
            PFX + "doctor.watchIntervalSecs": "0.2",
            PFX + "doctor.captureMs": "200",
            PFX + "doctor.captureDir": os.path.join(root, "capture"),
            PFX + "flightRecorder.enabled": "true",
            PFX + "flightRecorder.dir": os.path.join(root, "flight")}
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        w = svc.node.watcher
        h = write_maps(svc, 724, keys, values, MAPS)
        for _ in range(DIAGNOSIS_CORRUPT_READS):
            try:
                svc.read(h)
                raise AssertionError("diagnosis watcher: a read passed")
            except BlockCorruptionError:
                pass
        t0 = time.perf_counter()
        reads = 0
        while not w.captures:
            if time.perf_counter() - t0 > DIAGNOSIS_WATCH_S:
                raise AssertionError("diagnosis watcher: no capture")
            svc.read(h)
            torch.cuda.synchronize(dev)
            reads += 1
        capture_s = time.perf_counter() - t0
        again = w.check_once()
        caps = list(w.captures)
    if len(caps) != 1 or again:
        raise AssertionError(f"diagnosis watcher: {len(caps)} captures, "
                             f"{len(again)} on the second pass")
    cap = caps[0]
    if (cap["rule"], cap["grade"]) != DIAGNOSIS_DRILLS["corruption"] \
            or not cap["profile_dir"]:
        raise AssertionError(f"diagnosis watcher: capture {cap}")
    with open(os.path.join(cap["profile_dir"], "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    moves = [e for e in events if e.get("cat") == "kernel"
             and SEGMENT_MOVE_SYMBOL in str(e.get("name"))]
    with open(cap["flight_dump"]) as f:
        dump = json.load(f)
    dumped = {x["rule"] for x in dump.get("findings", [])
              if isinstance(x, dict)}
    if not moves or dump.get("finding", {}).get("rule") != cap["rule"] \
            or cap["rule"] not in dumped:
        raise AssertionError(f"diagnosis watcher: {len(moves)} segment "
                             f"moves in the profile, dump finding "
                             f"{dump.get('finding')}, findings {dumped}")
    return {"phase": "diagnosis_watcher", "captures": len(caps),
            "rule": cap["rule"], "grade": cap["grade"],
            "reads_until_capture": reads, "capture_s": capture_s,
            "profile_events": len(events), "segment_moves": len(moves),
            "kernel_device_ms": [e["dur"] / 1e3 for e in moves],
            "dump_findings": sorted(dumped),
            "second_pass_captures": len(again)}


def diagnosis_phase(dev) -> dict:
    """Phase 40 on main's records: diagnosis_anatomy, diagnosis_drills,
    diagnosis_watcher. The launch counts are set to 0 at the phase's
    start and read at its end (``diagnosis_launches``)."""
    import torch
    from sparkucx_tpu_torch import backend
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME
    from sparkucx_tpu_torch.ops.segmented import KERNEL_NAME as SEG
    t = time.perf_counter()
    keys, values = make_records(RECORDS, zipf=False, seed=SEED)
    gen_s = time.perf_counter() - t
    root = tempfile.mkdtemp(prefix="chip_smoke_diagnosis_")
    try:
        backend.reset_launch_counts()
        t = time.perf_counter()
        an = diagnosis_anatomy(dev, keys, values)
        an["seconds"] = time.perf_counter() - t
        t = time.perf_counter()
        dr = diagnosis_drills(dev, keys, values,
                              an["read_wall_median_ms"])
        dr["seconds"] = time.perf_counter() - t
        t = time.perf_counter()
        wa = diagnosis_watcher(dev, keys, values, root)
        wa["seconds"] = time.perf_counter() - t
        launches = {k: counted(k) for k in (KERNEL_NAME, SEG)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"gen_s": gen_s, "diagnosis_anatomy": {**an, "ok": True},
            "diagnosis_drills": {**dr, "ok": True},
            "diagnosis_watcher": {**wa, "ok": True},
            "diagnosis_launches": launches}


# -- the network half of telemetry: the live server, the CLI against it -----
LIVE_DURING = ("/healthz", "/metrics", "/snapshot")
LIVE_AFTER = ("/anatomy?trace={trace}", "/doctor", "/slo", "/decisions")
LIVE_CLI_S = 120.0             # each CLI subprocess's deadline


def scrape(url: str, timeout: float = 60.0) -> tuple:
    """One GET: (status, content type, body, ms). An error status is
    returned, not raised."""
    import urllib.error
    import urllib.request
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            status, ctype, body = r.status, r.headers["Content-Type"], \
                r.read()
    except urllib.error.HTTPError as e:
        status, ctype, body = e.code, e.headers["Content-Type"], e.read()
    return status, ctype, body, (time.perf_counter() - t0) * 1e3


def live_phase(dev, main_digests: dict) -> dict:
    """Phase 41 on main's records: the live server's routes during and
    after one main-size ``pallas`` read, and the CLI against it. The
    launch counts are set to 0 at the phase's start and read at its end
    (``live_launches``)."""
    import threading

    import torch
    from sparkucx_tpu_torch import backend, connect
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME
    from sparkucx_tpu_torch.utils.export import validate_exposition
    t = time.perf_counter()
    keys, values = make_records(RECORDS, zipf=False, seed=SEED)
    gen_s = time.perf_counter() - t
    conf = {PFX + "a2a.impl": "pallas", PFX + "metrics.httpPort": "0",
            PFX + "trace.enabled": "true", PFX + "decisions.enabled": "true",
            PFX + "slo.read.p99Ms": "60000",
            PFX + "history.windowSecs": "86400"}
    out = {"phase": "live", "card": card_line(), "gen_s": gen_s}
    backend.reset_launch_counts()
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        live = svc.node.live
        if live is None:
            raise AssertionError("live: the server did not bind "
                                 "(metrics.httpPort=0)")
        url = live.url
        h = write_maps(svc, 740, keys, values, MAPS)
        box = {}

        def read():
            try:
                t0 = time.perf_counter()
                res = svc.read(h)
                torch.cuda.synchronize(dev)
                box["read_ms"] = (time.perf_counter() - t0) * 1e3
                box["parts"] = [res.partition(r) for r in range(PARTITIONS)]
            except BaseException as e:      # re-raised below
                box["error"] = e

        reader = threading.Thread(target=read, name="live-read")
        t_read = time.perf_counter()
        reader.start()
        during, bodies = {}, {}
        for route in LIVE_DURING:
            status, ctype, body, ms = scrape(url + route)
            during[route] = {"status": status, "ms": ms,
                             "in_flight": reader.is_alive(),
                             "at_ms": (time.perf_counter() - t_read) * 1e3}
            bodies[route] = (status, ctype, body)
        reader.join()
        if "error" in box:
            raise box["error"]
        rep = svc.report(740)
        after = {}
        for route in LIVE_AFTER:
            path = route.format(trace=rep.trace_id)
            status, ctype, body, ms = scrape(url + path)
            after[route] = {"status": status, "ms": ms}
            bodies[route] = (status, ctype, body)
        # run from the checkout's root: ``-m`` finds the package there
        here = os.path.dirname(os.path.abspath(__file__))
        cli = {}
        for cmd in (["stats", "--live-url", url],
                    ["doctor", "--live-url", url]):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "sparkucx_tpu_torch",
                                *cmd], cwd=here,
                               capture_output=True, text=True,
                               timeout=LIVE_CLI_S)
            cli[cmd[0]] = {"rc": r.returncode,
                           "seconds": time.perf_counter() - t0,
                           "stdout_bytes": len(r.stdout)}
            if r.returncode != 0:
                raise AssertionError(f"live: python -m sparkucx_tpu_torch "
                                     f"{' '.join(cmd)} exited "
                                     f"{r.returncode}: {r.stderr[-2000:]}")
        led = _ledger_check("live read", rep)
        svc.unregister_shuffle(740)
    out["live_launches"] = counted(KERNEL_NAME)
    bad = {r: st for r, st in {**during, **after}.items()
           if st["status"] != 200}
    if bad:
        raise AssertionError(f"live: routes answered {bad}")
    if not during["/healthz"]["in_flight"]:
        raise AssertionError(f"live: /healthz answered only after the read "
                             f"settled ({during})")
    status, ctype, body = bodies["/metrics"]
    if not ctype.startswith("text/plain"):
        raise AssertionError(f"live: /metrics content type {ctype!r}")
    validate_exposition(body.decode())
    snap = json.loads(bodies["/snapshot"][2])
    if snap.get("process_id") != 0 or "counters" not in snap:
        raise AssertionError("live: /snapshot is not a snapshot document")
    an = json.loads(bodies["/anatomy?trace={trace}"][2])
    ledgers = an["ledgers"]
    if [lg["trace_id"] for lg in ledgers] != [rep.trace_id]:
        raise AssertionError(f"live: /anatomy ledgers "
                             f"{[lg['trace_id'] for lg in ledgers]} for "
                             f"{rep.trace_id}")
    # the route folds the snapshot's span ring; the report stamped the
    # tracer's fold at settle: the same ledger within their rounding
    lg = ledgers[0]
    total = sum(lg["phases_ms"].values()) + lg["dark_ms"]
    tol = 1e-3 * (len(lg["phases_ms"]) + 2)
    mine = {k: v for k, v in lg["phases_ms"].items() if v}
    stamped = {k: v for k, v in led["phases"].items() if v}
    if abs(total - lg["wall_ms"]) > tol \
            or abs(lg["wall_ms"] - led["anatomy_wall_ms"]) > tol \
            or set(mine) != set(stamped) \
            or any(abs(mine[k] - stamped[k]) > tol for k in mine):
        raise AssertionError(f"live: /anatomy {lg} against the report's "
                             f"{led}")
    slo = json.loads(bodies["/slo"][2])
    if [o["objective"] for o in slo["objectives"]] != ["slo.read.p99Ms"]:
        raise AssertionError(f"live: /slo {slo}")
    dec = json.loads(bodies["/decisions"][2])
    if not dec["enabled"]:
        raise AssertionError(f"live: /decisions {dec}")
    json.loads(bodies["/doctor"][2])
    got = partition_digests(box["parts"])
    if got != main_digests:
        bad = sorted(int(r) for r in main_digests
                     if got.get(r) != main_digests[r])
        raise AssertionError(f"live: partitions {bad[:8]} differ from "
                             f"main's")
    out.update(url=url, read_ms=box["read_ms"], trace_id=rep.trace_id,
               during=during, after=after,
               scrape_ms={**{r: st["ms"] for r, st in during.items()},
                          **{r: st["ms"] for r, st in after.items()}},
               anatomy={"wall_ms": lg["wall_ms"], "dark_ms": lg["dark_ms"],
                        "phases_ms": lg["phases_ms"]},
               metrics_bytes=len(bodies["/metrics"][2]),
               snapshot_bytes=len(bodies["/snapshot"][2]),
               decisions_total=dec["total"], cli=cli, ok=True)
    torch.cuda.empty_cache()
    return out


def dist_decisions(ctx, dev, keys, values, mine) -> dict:
    """``dist_decisions`` in a worker: a node of two slices (one a
    worker) under ``history.dir`` (shared by the workers) and the
    tracer; main's maps of this worker read flat in waves (WAVE_ROWS:
    the ``a2a.waveRows`` / ``a2a.waveSizes`` rounds) and two-tier
    (``tier.crossRows`` and the ``hier.*`` rounds). Returns the rounds
    the node's metrics counted and its ledger recorded, each read's
    agreement summary and trace id, the gathered spans and anchors."""
    from sparkucx_tpu_torch.utils.metrics import C_AGREE_ROUNDS
    t0 = time.perf_counter()
    hist = ctx.args["history_dir"]
    with ctx.connect({PFX + "mesh.numSlices": str(ctx.nprocs),
                      PFX + "history.dir": hist,
                      PFX + "trace.enabled": "true"}) as svc:
        node = svc.node
        node.tracer.clear()
        rounds0 = node.metrics.get(C_AGREE_ROUNDS)
        total0 = node.decisions.total
        reads = {}
        from sparkucx_tpu_torch.config import ShuffleConf
        from sparkucx_tpu_torch.shuffle.manager import ShuffleManager
        mw = ShuffleManager(node, ShuffleConf(
            {PFX + "a2a.topology": "flat",
             PFX + "a2a.waveRows": str(WAVE_ROWS)}, use_env=False))
        h = _own_maps(mw, 90, keys, values, mine)
        res = mw.read(h)
        del res
        reads["waved"] = mw.report(90)
        mw.unregister_shuffle(90)
        mw.stop()
        h = _own_maps(svc.manager, 91, keys, values, mine)
        res = svc.read(h)
        del res
        reads["tiered"] = svc.report(91)
        svc.unregister_shuffle(91)
        out = {"rounds": node.metrics.get(C_AGREE_ROUNDS) - rounds0,
               "records": node.decisions.total - total0,
               "ledger_path": node.decisions.path,
               "anchors": node.cluster_anchors,
               "spans": svc.manager.gather_spans()}
        for name, rep in reads.items():
            out[name] = {"trace_id": rep.trace_id, "waves": rep.waves,
                         "tiers": [t["tier"] for t in rep.tiers],
                         "agreement": rep.agreement,
                         "completed": rep.completed}
        node.tracer.enabled = False
        node.tracer.clear()
    out["seconds"] = time.perf_counter() - t0
    return out


def check_dist_decisions(results, history_dir: str) -> dict:
    """The parent's half of ``dist_decisions``: each worker's ledger
    recorded every round its metrics counted; both ledgers align round by
    round with one topic and one winner and the audit finds nothing;
    each read's agreement summary agrees across the workers; the
    gathered spans and anchors merge into one timeline with a track a
    worker holding both workers' read spans."""
    from sparkucx_tpu_torch.shuffle.decisions import (align_rounds,
                                                      audit_round,
                                                      decisions_files,
                                                      load_decisions_file)
    from sparkucx_tpu_torch.utils.export import merge_timeline
    st = [res["dist_decisions"] for res in results]
    paths = decisions_files(history_dir)
    for i, s in enumerate(st):
        if not (s["records"] == s["rounds"] > 0
                and s["ledger_path"] == paths[i]):
            raise AssertionError(f"dist_decisions (worker {i}): "
                                 f"{s['records']} records, {s['rounds']} "
                                 f"rounds, ledger {s['ledger_path']}")
    ledgers = {i: load_decisions_file(p) for i, p in enumerate(paths)}
    aligned = align_rounds(ledgers)
    findings = [audit_round(row) for row in aligned]
    split = [row for row in aligned
             if set(row["records"]) != {0, 1}
             or len({r["topic"] for r in row["records"].values()}) != 1
             or len({r["winner"] for r in row["records"].values()}) != 1]
    if len(paths) != 2 or any(findings) or split \
            or len(aligned) != st[0]["records"]:
        raise AssertionError(f"dist_decisions: {len(aligned)} rounds, "
                             f"findings {[f for f in findings if f]}, "
                             f"split {split[:2]}")
    for name in ("waved", "tiered"):
        a, b = (s[name] for s in st)
        if not (a["agreement"]["rounds"] == b["agreement"]["rounds"] > 0
                and a["trace_id"] == b["trace_id"] and a["completed"]):
            raise AssertionError(f"dist_decisions: {name} {a} {b}")
    anchors = {a["process_id"]: a for a in st[0]["anchors"]}
    docs = [dict(s, anchor=anchors[s["process_id"]])
            for s in st[0]["spans"]]
    doc = merge_timeline(docs)
    tracks = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e["name"] == "shuffle.exchange":
            tracks.setdefault(e["pid"], set()).add(e["args"]["trace"])
    want = {st[0]["waved"]["trace_id"], st[0]["tiered"]["trace_id"]}
    if sorted(tracks) != [0, 1] or any(v != want for v in tracks.values()):
        raise AssertionError(f"dist_decisions: timeline tracks {tracks}")
    topics = {}
    for r in ledgers[0]:
        topics[r["topic"]] = topics.get(r["topic"], 0) + 1
    return {"phase": "dist_decisions", "rounds": len(aligned),
            "topics": topics,
            "agree_ms": [sum(r["round_ms"] for r in ledgers[i])
                         for i in (0, 1)],
            "waved": [s["waved"]["agreement"] for s in st],
            "tiered": [s["tiered"]["agreement"] for s in st],
            "waves": st[0]["waved"]["waves"],
            "tiers": st[0]["tiered"]["tiers"],
            "timeline_events": len(doc["traceEvents"]),
            "seconds": [s["seconds"] for s in st], "ok": True}


# -- the facades: compat v2, checkpoints, the CLI's two commands, the
# -- kernel build cache (after every earlier phase) --------------------------
V2_SID = 220
V2_READERS = 4                 # range readers over [0, PARTITIONS)
FACADE_CLI_S = 600.0           # each CLI subprocess's deadline


def _report_line(rep) -> dict:
    return {"plan_ms": rep.plan_ms, "pack_ms": rep.pack_ms,
            "dispatch_ms": rep.dispatch_ms, "group_ms": rep.group_ms,
            "phases": rep.phases, "impl": rep.impl}


def compat_v2_phase(dev, keys, values, main_digests: dict,
                    main_read2_ms: float):
    """Main's shuffle through ``compat.version=v2``: every map written by
    attempt 0 (map 0's first attempt superseded by attempt 1, uncommitted;
    a retry of committed map 1 refused), then four range readers over
    [0, 200) sharing one segment move, then one ``read_device`` with no
    D2H before ``host_view()``. Returns (the line, the live service):
    the checkpoint phase snapshots its committed shuffle."""
    import torch
    from sparkucx_tpu_torch import backend, connect
    from sparkucx_tpu_torch.compat.v2 import (ShuffleDependency,
                                              ShuffleServiceV2)
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME
    conf = {PFX + "compat.version": "v2", PFX + "a2a.impl": "pallas"}
    svc = connect(conf, num_shards=SHARDS, use_env=False)
    if not isinstance(svc, ShuffleServiceV2):
        raise AssertionError(f"compat_v2: connect gave {type(svc)}")
    out = {"phase": "compat_v2", "card": card_line(), "records": RECORDS,
           "maps": MAPS, "partitions": PARTITIONS, "shards": SHARDS}
    h = svc.register(ShuffleDependency(V2_SID, MAPS, PARTITIONS))
    per = -(-keys.shape[0] // MAPS)
    t = time.perf_counter()
    stale = svc.writer(h, 0, attempt_id=0)
    stale.write(keys[:per // 2], values[:per // 2])
    for m in range(MAPS):
        sl = slice(m * per, min((m + 1) * per, keys.shape[0]))
        w = svc.writer(h, m, attempt_id=1 if m == 0 else 0)
        w.write(keys[sl], values[sl])
        w.commit()
    out["write_s"] = time.perf_counter() - t
    try:
        stale.commit()
        raise AssertionError("compat_v2: a superseded attempt published")
    except RuntimeError as e:
        if "released" not in str(e):
            raise
    try:
        svc.writer(h, 1, attempt_id=1)
        raise AssertionError("compat_v2: a committed map took a retry")
    except RuntimeError as e:
        if "first commit" not in str(e):
            raise
    cached0 = svc.node.metrics.get("shuffle.read.cached.count")
    backend.reset_launch_counts()
    t = time.perf_counter()
    parts = {}
    edges = [i * PARTITIONS // V2_READERS for i in range(V2_READERS + 1)]
    for lo, hi in zip(edges[:-1], edges[1:]):
        for r, kv in svc.reader(h, lo, hi):
            parts[r] = kv
    torch.cuda.synchronize(dev)
    out["read_ms"] = (time.perf_counter() - t) * 1e3
    out["launches"] = counted(KERNEL_NAME)
    out["cached_reads"] = int(svc.node.metrics.get(
        "shuffle.read.cached.count") - cached0)
    if out["launches"] != 1 or out["cached_reads"] != V2_READERS - 1:
        raise AssertionError(f"compat_v2: {out['launches']} segment moves, "
                             f"{out['cached_reads']} cached readers for "
                             f"{V2_READERS} readers")
    if partition_digests(parts) != main_digests:
        raise AssertionError("compat_v2: partitions differ from main's")
    out["report"] = _report_line(svc.report(V2_SID))
    out["main_read2_ms"] = main_read2_ms
    del parts
    t = time.perf_counter()
    res = svc.read_device(h)
    torch.cuda.synchronize(dev)
    out["read_device_ms"] = (time.perf_counter() - t) * 1e3
    rep = svc.report(V2_SID)
    out["read_device_d2h_before_host_view"] = rep.d2h_bytes
    if rep.d2h_bytes != 0 or rep.sink != "device":
        raise AssertionError(f"compat_v2: read_device sink {rep.sink}, "
                             f"d2h {rep.d2h_bytes} before host_view")
    view = res.host_view()
    dparts = {r: view.partition(r) for r in range(PARTITIONS)}
    out["read_device_d2h_after_host_view"] = svc.report(V2_SID).d2h_bytes
    if partition_digests(dparts) != main_digests:
        raise AssertionError("compat_v2: read_device partitions differ")
    del dparts, view, res
    out["ok"] = True
    return out, svc


def checkpoint_phase(dev, svc, main_digests: dict, root: str) -> dict:
    """``snapshot_shuffles`` of the v2 service's committed shuffle (main's
    records), the service closed, a fresh one restoring and reading it
    (``pallas``); then a TrainCheckpointer round trip of the moe_train
    layer's parameters and Adam state on the card."""
    import torch
    from sparkucx_tpu_torch import backend, connect
    from sparkucx_tpu_torch.models import moe as tm
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME
    from sparkucx_tpu_torch.runtime.checkpoint import (TrainCheckpointer,
                                                       restore_shuffles,
                                                       snapshot_shuffles)
    out = {"phase": "checkpoint", "card": card_line()}
    snap = os.path.join(root, "snap")
    t = time.perf_counter()
    n = snapshot_shuffles(svc.manager, snap)
    out["snapshot_write_s"] = time.perf_counter() - t
    out["snapshot_bytes"] = sum(os.path.getsize(os.path.join(snap, f))
                                for f in os.listdir(snap))
    svc.stop()
    if n != 1:
        raise AssertionError(f"checkpoint: {n} shuffles snapshotted")
    with connect({PFX + "a2a.impl": "pallas"}, num_shards=SHARDS,
                 use_env=False) as fresh:
        t = time.perf_counter()
        handles = restore_shuffles(fresh.manager, snap)
        out["restore_s"] = time.perf_counter() - t
        backend.reset_launch_counts()
        parts, read_ms, views_ms = drive_read(fresh, handles[V2_SID])
        out["restored_launches"] = counted(KERNEL_NAME)
        out["restored_read_ms"] = read_ms
        if partition_digests(parts) != main_digests:
            raise AssertionError("checkpoint: restored partitions differ "
                                 "from main's")
        del parts
    # the moe_train layer (raw wire): two Adam steps, a save, one more
    # step; then a fresh layer restored from the save takes the same step
    cfg = moe_config("raw")
    params0, x, y = moe_inputs(dev)
    init, step = tm.make_train_step(cfg, MOE_DP, MOE_EP, lr=MOE_LR,
                                    device=dev)
    params, opt = init(params0)
    for _ in range(2):
        params, opt, _ = step(params, opt, x, y)

    def state_of(p, o):
        return {"params": {k: p[k].detach() for k in tm.PARAM_NAMES},
                "opt": o.state_dict()}

    ck_dir = os.path.join(root, "train")
    with TrainCheckpointer(ck_dir, keep=2) as ck:
        t = time.perf_counter()
        ck.save(2, state_of(params, opt))
        out["train_save_s"] = time.perf_counter() - t
        out["train_bytes"] = sum(os.path.getsize(os.path.join(ck_dir, f))
                                 for f in os.listdir(ck_dir))
        saved = {k: v.detach().clone() for k, v in params.items()}
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            params, opt, loss_a = step(params, opt, x, y)
            after_a = {k: v.detach().clone() for k, v in params.items()}
            params2, opt2 = init(params0)
            t = time.perf_counter()
            got = ck.restore(target=state_of(params, opt))
            torch.cuda.synchronize(dev)
            out["train_restore_s"] = time.perf_counter() - t
            for k in tm.PARAM_NAMES:
                if not torch.equal(got["params"][k], saved[k]):
                    raise AssertionError(f"checkpoint: parameter {k} not "
                                         f"restored bit for bit")
            with torch.no_grad():
                for k in tm.PARAM_NAMES:
                    params2[k].copy_(got["params"][k])
            opt2.load_state_dict(got["opt"])
            params2, opt2, loss_b = step(params2, opt2, x, y)
        finally:
            torch.use_deterministic_algorithms(False)
    diffs = {k: float((params2[k].detach() - after_a[k]).abs().max())
             for k in tm.PARAM_NAMES}
    out["train_step_max_abs_diff"] = max(diffs.values())
    out["train_loss_after_save"] = float(loss_a)
    out["train_loss_after_restore"] = float(loss_b)
    if any(not torch.equal(params2[k].detach(), after_a[k])
           for k in tm.PARAM_NAMES) or float(loss_a) != float(loss_b):
        raise AssertionError(f"checkpoint: the step after the restore "
                             f"differs from the step without one: {diffs}")
    out["ok"] = True
    return out


def cli_run(args: list, timeout: float = FACADE_CLI_S) -> tuple:
    """``python -m sparkucx_tpu_torch <args>`` from the checkout's root:
    (return code, stdout, stderr, seconds)."""
    here = os.path.dirname(os.path.abspath(__file__))
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "sparkucx_tpu_torch", *args],
                       cwd=here, capture_output=True, text=True,
                       timeout=timeout)
    return r.returncode, r.stdout, r.stderr, time.perf_counter() - t


def kernelbench_phase(root: str) -> dict:
    """The ported kernelbench through the CLI at 2^20 rows: exit 0, all
    five parity grades ok, the kernels' and the twins' times per case."""
    out_path = os.path.join(root, "kernelbench.json")
    rc, stdout, stderr, secs = cli_run(["kernelbench", "--rows-log2", "20",
                                        "--out", out_path])
    if rc != 0:
        if os.path.exists(out_path):
            with open(out_path) as f:
                doc = json.load(f)
            stderr = json.dumps({"programs": doc["programs"], "parity": {
                c["case"]: c["parity"] for c in doc["cases"]}})
        raise AssertionError(f"kernelbench exited {rc}: {stderr[-2000:]}")
    with open(out_path) as f:
        doc = json.load(f)
    cases = {c["case"]: {"cuda_ms": c["cuda"].get("wall_ms"),
                         "torch_ms": c["torch"]["wall_ms"],
                         "parity": c["parity"]} for c in doc["cases"]}
    bad = [n for n, c in cases.items()
           if c["parity"].get("status") != "ok" or not c["parity"]["ok"]]
    if len(cases) != 5 or bad or not doc["native_cuda"]:
        raise AssertionError(f"kernelbench: grades failed for {bad}")
    from sparkucx_tpu_torch.ops.segmented import (KERNEL_NAME,
                                                  WIRE_KERNEL_NAME)
    silent = [k for k in (KERNEL_NAME, WIRE_KERNEL_NAME)
              if doc["launches"].get(k, 0) <= 0]
    if silent:
        raise AssertionError(f"kernelbench: {silent} never launched: "
                             f"{doc['launches']}")
    return {"phase": "kernelbench", "card": card_line(), "seconds": secs,
            "cases": cases, "programs": doc["programs"],
            "launches": doc["launches"], "ok": True}


def workload_cli_phase(dev, keys, values, main_digests: dict) -> dict:
    """``python -m sparkucx_tpu_torch workload terasort`` at the
    registry's defaults; then main's shuffle under ``io.format=arrow``
    where pyarrow imports."""
    rc, stdout, stderr, secs = cli_run(["workload", "terasort"])
    if rc != 0:
        raise AssertionError(f"workload terasort exited {rc}: "
                             f"{stderr[-2000:]}")
    rep = json.loads(stdout)
    if not rep["oracle_ok"]:
        raise AssertionError("workload terasort: oracle failed")
    out = {"phase": "workload_cli", "card": card_line(), "seconds": secs,
           "rows_in": rep["rows_in"], "wall_s": rep.get("wall_s"),
           "phases": rep["phases"], "oracle_ok": True}
    from sparkucx_tpu_torch.io.arrow import HAVE_ARROW
    print(json.dumps({"phase": "arrow", "pyarrow": HAVE_ARROW}), flush=True)
    if HAVE_ARROW:
        import pyarrow as pa
        from sparkucx_tpu_torch import connect
        from sparkucx_tpu_torch.io.arrow import batch_to_kv
        conf = {PFX + "a2a.impl": "pallas", PFX + "io.format": "arrow"}
        with connect(conf, num_shards=SHARDS, use_env=False) as svc:
            h = svc.register_shuffle(230, MAPS, PARTITIONS)
            per = -(-keys.shape[0] // MAPS)
            for m in range(MAPS):
                sl = slice(m * per, min((m + 1) * per, keys.shape[0]))
                cols = {"key": keys[sl]}
                cols.update({f"v{j}": values[sl, j]
                             for j in range(VALUE_WORDS)})
                svc.write(h, m, pa.record_batch(cols))
            t = time.perf_counter()
            batches = svc.read(h)
            out["arrow_read_ms"] = (time.perf_counter() - t) * 1e3
            parts = {}
            for b in batches:
                k, v, _ = batch_to_kv(b, "key")
                r = int(hash_pid(k[:1], PARTITIONS)[0])
                parts[r] = (k, v)
            for r in range(PARTITIONS):
                parts.setdefault(r, (np.zeros(0, np.int64),
                                     np.zeros((0, VALUE_WORDS), np.int32)))
            if partition_digests(parts) != main_digests:
                raise AssertionError("arrow: partitions differ from main's")
    out["ok"] = True
    return out


def compile_cache_phase() -> dict:
    """A fresh process with ``compile.cacheDir`` at the directory the
    smoke's build went into: it loads the library without nvcc."""
    from sparkucx_tpu_torch import backend
    here = os.path.dirname(os.path.abspath(__file__))
    cache = str(backend.build_dir())
    code = (
        "import json, time\n"
        "from sparkucx_tpu_torch import backend, connect\n"
        "from sparkucx_tpu_torch.runtime.compile_cache import "
        "cache_entry_count\n"
        f"svc = connect({{'{PFX}compile.cacheDir': {cache!r}}}, "
        "num_shards=1, use_env=False)\n"
        "t = time.perf_counter()\n"
        "backend.kernel_library()\n"
        "ms = (time.perf_counter() - t) * 1e3\n"
        "svc.stop()\n"
        "print(json.dumps({'builds': backend.build_count(), 'load_ms': ms,"
        f" 'entries': cache_entry_count({cache!r})}}))\n")
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], cwd=here,
                       capture_output=True, text=True, timeout=FACADE_CLI_S)
    secs = time.perf_counter() - t
    if r.returncode != 0:
        raise AssertionError(f"compile_cache: child exited {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    doc = json.loads(r.stdout.strip().splitlines()[-1])
    if doc["builds"] != 0 or doc["entries"] < 1:
        raise AssertionError(f"compile_cache: the child built {doc}")
    return {"phase": "compile_cache", "card": card_line(), "dir": cache,
            "seconds": secs, **doc, "ok": True}


def facades_phase(dev, main_digests: dict, main_read2_ms: float) -> dict:
    """The slice's phases in turn on main's records, each line printed as
    its phase ends; each sets the launch counts to 0 before its path and
    reads them after."""
    t = time.perf_counter()
    keys, values = make_records(RECORDS, zipf=False, seed=SEED)
    out = {"gen_s": time.perf_counter() - t}
    root = tempfile.mkdtemp(prefix="chip_smoke_facades_")

    def done(name: str, line: dict) -> None:
        out[name] = line
        print(json.dumps(line), flush=True)
    try:
        cv, svc = compat_v2_phase(dev, keys, values, main_digests,
                                  main_read2_ms)
        done("compat_v2", cv)
        # the checkpoint phase closes the v2 service after its snapshot
        done("checkpoint", checkpoint_phase(dev, svc, main_digests, root))
        done("kernelbench", kernelbench_phase(root))
        done("workload_cli", workload_cli_phase(dev, keys, values,
                                                main_digests))
        done("compile_cache", compile_cache_phase())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        log("chip_smoke: torch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is "
            "false); this smoke runs only on the card")
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from sparkucx_tpu_torch import backend, connect
    except ImportError as e:
        log(f"chip_smoke: the port package is not beside this script: {e}")
        return 2
    from sparkucx_tpu_torch.ops.ragged_a2a import KERNEL_NAME
    from sparkucx_tpu_torch.ops.segmented import KERNEL_NAME as SEG_KERNEL
    from sparkucx_tpu_torch.ops.segmented import \
        MERGE_KERNEL_NAME as MERGE_KERNEL
    from sparkucx_tpu_torch.ops.quant import KERNEL_NAME as QUANT_KERNEL
    from sparkucx_tpu_torch.ops.segmented import \
        WIRE_KERNEL_NAME as WIRE_KERNEL

    dev = card_device()
    print(card_line(), flush=True)      # "<name>, <power limit>"
    backend.check_sm90(dev)
    # the streaming phase's child gets its interpreter, CUDA context and
    # records ready during the build; it does no work on the card before
    # that phase
    held_child_proc = HeldChild()

    t = time.perf_counter()
    backend.kernel_library()
    build_s = time.perf_counter() - t
    for entry in backend.build_log:
        for line in entry.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas: {line.strip()}")
    print(json.dumps({"phase": "build", "seconds": build_s}), flush=True)
    # spills and deferred reads of every earlier phase (all must be 0)
    planes = PlaneTally().install()

    t = time.perf_counter()
    cases = kernel_phase(dev)
    print(json.dumps({"phase": "kernel", "cases": cases, "ok": True,
                      "seconds": time.perf_counter() - t}), flush=True)

    planes.cut("kernel")
    t = time.perf_counter()
    seg_cases = segreduce_kernel_phase(dev)
    print(json.dumps({"phase": "segreduce_kernel", **seg_cases, "ok": True,
                      "seconds": time.perf_counter() - t}), flush=True)

    planes.cut("segreduce_kernel")
    t = time.perf_counter()
    merge_cases = merge_kernel_phase(dev)
    print(json.dumps({"phase": "merge_kernel", "cases": merge_cases,
                      "ok": True, "seconds": time.perf_counter() - t}),
          flush=True)

    planes.cut("merge_kernel")
    # -- main path: TeraSort records, 200 partitions, 8 shards -----------
    conf = {"spark.shuffle.tpu.a2a.impl": "pallas"}
    t = time.perf_counter()
    keys, values = make_records(RECORDS, zipf=False, seed=SEED)
    gen_s = time.perf_counter() - t
    with connect(conf, num_shards=SHARDS, use_env=False) as svc:
        # warm the torch ops the step uses (not counted, not timed)
        wk, wv = make_records(1 << 16, zipf=False, seed=SEED + 1)
        drive_read(svc, write_maps(svc, 1, wk, wv, 8))
        svc.unregister_shuffle(1)
        t = time.perf_counter()
        h = write_maps(svc, 2, keys, values, MAPS)
        write_s = time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats(dev)
        backend.reset_launch_counts()
        parts, read_ms, views_ms = drive_read(svc, h)
        launches = counted(KERNEL_NAME)
        peak = torch.cuda.max_memory_allocated(dev)
        rep = svc.report(2)
        t = time.perf_counter()
        check_against_oracle(parts, keys, values, PARTITIONS)
        check_s = time.perf_counter() - t
        # what the distributed phase's workers must deliver
        main_digests = partition_digests(parts)
        del parts
        # steady state: the same read again (pinned pack buffer reused)
        parts2, read2_ms, views2_ms = drive_read(svc, h)
        del parts2
        rep2 = svc.report(2)
        prof = profiled_read(svc, h)
        # -- streaming: the same shuffle read in arrival order
        stream = streaming_phase(svc, h, dev, main_digests,
                                 rep2.d2h_bytes, held_child_proc)
        held_child_proc.close()
        svc.unregister_shuffle(2)
    payload = rep.payload_bytes
    print(json.dumps({
        "phase": "main", "records": RECORDS, "maps": MAPS,
        "partitions": PARTITIONS, "shards": SHARDS, "impl": rep.impl,
        "payload_bytes": payload, "wire_bytes": rep.wire_bytes,
        "retries": rep.retries, "plan_bucket": rep.plan_bucket,
        "read_ms": read_ms, "views_ms": views_ms,
        "payload_gbps": payload / read_ms / 1e6,
        "end_to_end_gbps": payload / (read_ms + views_ms) / 1e6,
        "read2_ms": read2_ms, "views2_ms": views2_ms,
        "read2_gbps": payload / read2_ms / 1e6,
        "read2_pack_ms": rep2.pack_ms, "read2_group_ms": rep2.group_ms,
        "read2_dispatch_ms": rep2.dispatch_ms,
        "plan_ms": rep.plan_ms, "pack_ms": rep.pack_ms,
        "dispatch_ms": rep.dispatch_ms, "group_ms": rep.group_ms,
        "peak_device_bytes": peak, "launches": launches,
        "integrity": rep.integrity, "integrity_bytes": rep.integrity_bytes,
        "gen_s": gen_s, "write_s": write_s, "oracle_s": check_s,
        "ok": True}), flush=True)
    print(json.dumps({"phase": "main_profile", **prof}), flush=True)
    print(json.dumps(stream), flush=True)

    planes.cut("main")
    main_line = {"main_write_s": write_s, "main_read_ms": read_ms,
                 "main_pack_ms": rep.pack_ms, "main_read2_ms": read2_ms,
                 "main_read2_pack_ms": rep2.pack_ms,
                 "main_integrity": rep.integrity,
                 "main_integrity_bytes": rep.integrity_bytes}
    kt = kernel_at_main_shapes(keys, values, rep, dev)
    print(json.dumps({"phase": "kernel_at_main_shapes", **kt}), flush=True)

    planes.cut("kernel_at_main_shapes")
    # -- ordered: TeraSort proper (range partitioner, sorted partitions) --
    t = time.perf_counter()
    od, oprof = ordered_phase(dev, conf, keys, values)
    print(json.dumps({**od, "seconds": time.perf_counter() - t}),
          flush=True)
    print(json.dumps({"phase": "ordered_profile", **oprof}), flush=True)

    planes.cut("ordered")
    # -- waved_ordered: TeraSort in 5 waves, folded on the device --------
    t = time.perf_counter()
    wo, woprof, captured = waved_ordered_phase(dev, keys, values)
    print(json.dumps({**wo, "seconds": time.perf_counter() - t}),
          flush=True)
    print(json.dumps({"phase": "waved_ordered_profile", **woprof}),
          flush=True)
    merge_launches = wo["device"]["launches"][MERGE_KERNEL]
    del keys, values
    planes.cut("waved_ordered")
    mt = merge_at_main_shapes(captured, dev)
    del captured
    print(json.dumps({"phase": "merge_at_main_shapes", **mt}), flush=True)

    planes.cut("merge_at_main_shapes")
    # -- skew + regrow: Zipf(1.1), capacityFactor 0.5 --------------------
    skew_conf = {"spark.shuffle.tpu.a2a.impl": "pallas",
                 "spark.shuffle.tpu.a2a.capacityFactor": "0.5"}
    sk, sv = make_records(SKEW_RECORDS, zipf=True, seed=SEED + 2)
    with connect(skew_conf, num_shards=SHARDS, use_env=False) as svc:
        h = write_maps(svc, 3, sk, sv, MAPS)
        backend.reset_launch_counts()
        parts, sread_ms, sviews_ms = drive_read(svc, h)
        skew_launches = counted(KERNEL_NAME)
        srep = svc.report(3)
        check_against_oracle(parts, sk, sv, PARTITIONS)
    if srep.retries < 1:
        raise AssertionError("the skew phase was meant to overflow first")
    print(json.dumps({
        "phase": "skew", "records": SKEW_RECORDS, "retries": srep.retries,
        "plan_bucket": srep.plan_bucket, "skew_ratio": srep.skew_ratio,
        "read_ms": sread_ms, "views_ms": sviews_ms,
        "pack_ms": srep.pack_ms, "dispatch_ms": srep.dispatch_ms,
        "group_ms": srep.group_ms, "launches": skew_launches, "ok": True}),
        flush=True)

    planes.cut("skew")
    # -- combine: group-by-sum through the segment-reduce kernel ---------
    comb_conf = {"spark.shuffle.tpu.a2a.impl": "pallas",
                 "spark.shuffle.tpu.read.mergeImpl": "auto"}
    t = time.perf_counter()
    cb, cprof, crep, ck, cv, part_rows = combine_phase(dev, comb_conf)
    print(json.dumps({**cb, "seconds": time.perf_counter() - t}), flush=True)
    print(json.dumps({"phase": "combine_profile", **cprof}), flush=True)
    seg_launches = cb["launches"][SEG_KERNEL]
    planes.cut("combine")
    st = segreduce_at_main_shapes(ck, cv, crep, part_rows, dev)
    print(json.dumps({"phase": "segreduce_at_main_shapes", **st}),
          flush=True)

    planes.cut("segreduce_at_main_shapes")
    t = time.perf_counter()
    wc, wl = waved_combine_phase(dev, ck, cv)
    print(json.dumps({**wc, "seconds": time.perf_counter() - t}),
          flush=True)
    print(json.dumps(wl), flush=True)
    del ck, cv

    planes.cut("waved_combine")
    t = time.perf_counter()
    cf = combine_f32_phase(dev, comb_conf)
    print(json.dumps({**cf, "seconds": time.perf_counter() - t}), flush=True)

    planes.cut("combine_f32")
    # -- int8 wire: the two kernels, then a DLRM-style embedding-gradient
    # shuffle (after every earlier phase, which run as they did before)
    t = time.perf_counter()
    quant_cases = quant_kernel_phase(dev)
    print(json.dumps({"phase": "quant_kernel", "cases": quant_cases,
                      "ok": True, "seconds": time.perf_counter() - t}),
          flush=True)

    planes.cut("quant_kernel")
    t = time.perf_counter()
    wire_cases = wire_reduce_kernel_phase(dev)
    print(json.dumps({"phase": "wire_reduce_kernel", **wire_cases,
                      "ok": True, "seconds": time.perf_counter() - t}),
          flush=True)

    planes.cut("wire_reduce_kernel")
    t = time.perf_counter()
    i8, box, i8_part_rows, i8_stats = int8_phases(dev)
    for name in ("int8_plain", "int8_combine", "waved_int8_combine"):
        print(json.dumps(i8[name]), flush=True)
    print(json.dumps({"phase": "int8", "gen_s": i8["gen_s"],
                      "seconds": time.perf_counter() - t}), flush=True)
    planes.cut("int8")
    qt = quant_at_main_shapes(box)
    print(json.dumps({"phase": "quant_at_main_shapes", **qt}), flush=True)
    planes.cut("quant_at_main_shapes")
    wt = wire_reduce_at_main_shapes(box, i8_part_rows, dev)
    del box
    print(json.dumps({"phase": "wire_reduce_at_main_shapes", **wt}),
          flush=True)

    planes.cut("wire_reduce_at_main_shapes")
    t = time.perf_counter()
    dc = default_conf_phase(dev)
    print(json.dumps({**dc, "seconds": time.perf_counter() - t}),
          flush=True)

    planes.cut("default_conf")
    # -- attention: the flash kernels, then one LLaMA-2-7B-32K attention
    # layer through the device sink (after every earlier phase)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: fp32
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    fk = flash_kernels_phase(dev)
    print(json.dumps({"phase": "flash_kernels", **fk, "ok": True,
                      "seconds": time.perf_counter() - t}), flush=True)

    planes.cut("flash_kernels")
    t = time.perf_counter()
    ua, uprof, qkv, fwd_ref = ulysses_phase(dev)
    print(json.dumps({**ua, "seconds": time.perf_counter() - t}), flush=True)
    print(json.dumps(uprof), flush=True)

    planes.cut("ulysses_attention")
    t = time.perf_counter()
    ut, cot, bwd_ref = ulysses_train_phase(dev, qkv, fwd_ref)
    print(json.dumps({**ut, "seconds": time.perf_counter() - t}), flush=True)

    planes.cut("ulysses_attention_train")
    t = time.perf_counter()
    ra = ring_phase(dev)
    print(json.dumps({**ra, "seconds": time.perf_counter() - t}), flush=True)

    planes.cut("ring_attention")
    t = time.perf_counter()
    fm = flash_at_main_shapes(dev, qkv, cot, fwd_ref, bwd_ref)
    del qkv, cot, fwd_ref, bwd_ref
    print(json.dumps({"phase": "flash_at_main_shapes", **fm,
                      "seconds": time.perf_counter() - t}), flush=True)
    planes.cut("flash_at_main_shapes")
    # -- workloads: every analytics runner through the default conf
    t = time.perf_counter()
    wl = workloads_phase(dev)
    wl_launches = {k: sum(w["launches"][k] for w in wl.values())
                   for k in (KERNEL_NAME, SEG_KERNEL)}
    print(json.dumps({"phase": "workloads", "runners": list(wl),
                      "launches": wl_launches, "ok": True,
                      "seconds": time.perf_counter() - t}), flush=True)
    planes.cut("workloads")
    planes.uninstall()
    spilled = {ph: c for ph, c in planes.phases.items() if any(c.values())}
    print(json.dumps({"phase": "earlier_phases_memory_planes",
                      "phases": planes.phases, "ok": not spilled}),
          flush=True)
    if spilled:
        raise AssertionError(f"earlier phases spilled or deferred: {spilled}")

    # -- the memory planes: spill, admission, the external-memory
    # pipelines (after every earlier phase, on main's records again)
    spill_root = tempfile.mkdtemp(prefix="chip_smoke_spill_")
    try:
        keys, values = make_records(RECORDS, zipf=False, seed=SEED)
        t = time.perf_counter()
        sp = spill_phase(dev, keys, values, os.path.join(spill_root, "spill"))
        print(json.dumps({**sp, **main_line,
                          "seconds": time.perf_counter() - t}), flush=True)
        t = time.perf_counter()
        ad = admission_phase(dev, keys, values)
        print(json.dumps({**ad, "seconds": time.perf_counter() - t}),
              flush=True)
        del keys, values
        t = time.perf_counter()
        pl = pipelines_phase(dev, spill_root)
        pl_launches = {k: sum(p["launches"][k] for p in pl.values())
                       for k in (KERNEL_NAME, MERGE_KERNEL, SEG_KERNEL)}
        print(json.dumps({"phase": "pipelines", "runs": list(pl),
                          "launches": pl_launches, "ok": True,
                          "seconds": time.perf_counter() - t}), flush=True)
    finally:
        shutil.rmtree(spill_root, ignore_errors=True)

    # -- the expert-parallel MoE: Switch-Base-8 trained on both wires,
    # then dispatched through the read path (float32 products: TF32 is
    # off since the attention phases)
    t = time.perf_counter()
    mo, moe_params, moe_x = moe_train_phase(dev)
    print(json.dumps({"phase": "moe_train", **mo,
                      "seconds": time.perf_counter() - t}), flush=True)
    t = time.perf_counter()
    md = moe_dispatch_phase(dev, moe_params, moe_x)
    del moe_params, moe_x
    print(json.dumps({"phase": "moe_dispatch", **md,
                      "seconds": time.perf_counter() - t}), flush=True)

    # -- the five-axis MoE transformer at Switch-Base-8's widths, trained
    # through the exchange and the flash kernels; then a dp x tp x ep grid
    # on the ring in float32 and bfloat16
    t = time.perf_counter()
    tf = transformer_train_phase(dev)
    print(json.dumps({"phase": "transformer_train", **tf,
                      "seconds": time.perf_counter() - t}), flush=True)
    t = time.perf_counter()
    tm2 = transformer_mesh2_phase(dev)
    print(json.dumps({"phase": "transformer_mesh2", **tm2,
                      "seconds": time.perf_counter() - t}), flush=True)

    # -- the two-tier topology plane on a 2 x 4 slice grid, then io/dlpack
    t = time.perf_counter()
    hi = hier_phase(dev)
    for name in ("hier_plain", "hier_device", "hier_ordered", "hier_waved",
                 "hier_combine", "hier_int8"):
        print(json.dumps(hi[name]), flush=True)
    print(json.dumps({"phase": "hier", "seconds": time.perf_counter() - t}),
          flush=True)
    t = time.perf_counter()
    dl = dlpack_phase(dev)
    print(json.dumps({**dl, "seconds": time.perf_counter() - t}), flush=True)

    # -- the multi-process read plane: two workers sharing the card
    t = time.perf_counter()
    di = dist_phase(dev, main_digests)
    print(json.dumps({"phase": "dist_world", **di["world"]}), flush=True)
    for name in ("dist_plain", "dist_replay", "dist_full", "dist_combine",
                 "dist_int8",
                 "dist_int8_combine", "dist_hier",
                 "dist_waved_ordered_device", "dist_waved_ordered_host",
                 "dist_decisions", "dist_fleet", "dist_async",
                 "dist_one_armed", "dist_peer_loss"):
        print(json.dumps(di[name]), flush=True)
    print(json.dumps({"phase": "distributed",
                      "launches": di["dist_launches"],
                      "seconds": time.perf_counter() - t}), flush=True)
    dist_launches = di["dist_launches"]

    # -- the failure plane: replayed reads (single-shot, waved, tiered,
    # the recovery ledger) and the pool / fetch surface
    t = time.perf_counter()
    fa = faults_phase(dev, main_digests, launches)
    for name in ("faults_single", "faults_ledger", "faults_small",
                 "faults_surface", "faults_waved", "faults_tiered"):
        print(json.dumps(fa[name]), flush=True)
    faults_launches = {
        KERNEL_NAME: fa["faults_single"]["launches"].get(KERNEL_NAME, 0)
        + fa["faults_ledger"]["launches"].get(KERNEL_NAME, 0),
        MERGE_KERNEL: fa["faults_waved"]["replayed"]["launches"].get(
            MERGE_KERNEL, 0),
        SEG_KERNEL: fa["faults_waved"]["replayed"]["launches"].get(
            SEG_KERNEL, 0),
        QUANT_KERNEL: fa["faults_tiered"]["replayed"]["quantize_launches"]}
    print(json.dumps({"phase": "faults", "gen_s": fa["gen_s"],
                      "faults_launches": faults_launches,
                      "seconds": time.perf_counter() - t}), flush=True)

    # -- the integrity and durability plane: the verify levels at main's
    # size, the corrupt sites, each mode's verdict, the SIGKILL restart
    t = time.perf_counter()
    ig = integrity_phase(dev, main_digests, launches, main_line)
    for name in ("integrity_levels", "integrity_corrupt", "integrity_modes",
                 "restart_drill"):
        print(json.dumps(ig[name]), flush=True)
    modes = ig["integrity_modes"]["launches"]
    integrity_launches = {
        KERNEL_NAME: sum(ig["integrity_levels"][level]["launches"]
                         for level in ("off", "staged", "full"))
        + ig["integrity_corrupt"]["launches"][KERNEL_NAME]
        + modes[KERNEL_NAME]
        + ig["restart_drill"]["launches"][KERNEL_NAME],
        MERGE_KERNEL: modes[MERGE_KERNEL], SEG_KERNEL: modes[SEG_KERNEL],
        QUANT_KERNEL: modes[QUANT_KERNEL]}
    print(json.dumps({"phase": "integrity", "gen_s": ig["gen_s"],
                      "integrity_launches": integrity_launches,
                      "seconds": time.perf_counter() - t}), flush=True)

    # -- the tenancy plane: a whale and eight minnows through read_async,
    # fair share against FIFO, the per-tenant overrides and a quota
    t = time.perf_counter()
    tn = tenancy_phase(dev, main_digests)
    for name in ("tenancy_solo", "tenancy_fair", "tenancy_fifo",
                 "tenancy_overrides", "tenancy_quota"):
        print(json.dumps(tn[name]), flush=True)
    tenancy_launches = tn["tenancy_launches"]
    print(json.dumps({"phase": "tenancy", "gen_s": tn["gen_s"],
                      "whale_footprint": tn["whale_footprint"],
                      "minnow_footprint": tn["minnow_footprint"],
                      "peak_device_bytes": tn["peak_device_bytes"],
                      "tenancy_launches": tenancy_launches,
                      "seconds": time.perf_counter() - t}), flush=True)

    # -- the telemetry plane: the tracer's cost and main's read by span,
    # the device trace, the device-memory sampler, the snapshot and the
    # history, a postmortem of a read in flight
    t = time.perf_counter()
    te = telemetry_phase(dev)
    for name in ("telemetry_trace", "telemetry_devmon", "telemetry_snapshot",
                 "telemetry_flight"):
        print(json.dumps(te[name]), flush=True)
    print(json.dumps({"phase": "telemetry", "gen_s": te["gen_s"],
                      "telemetry_launches": te["telemetry_launches"],
                      "seconds": time.perf_counter() - t}), flush=True)

    # -- the diagnosis plane: main's read by phase (the anatomy), the
    # doctor's drills, the watcher's capture
    t = time.perf_counter()
    dg = diagnosis_phase(dev)
    for name in ("diagnosis_anatomy", "diagnosis_drills",
                 "diagnosis_watcher"):
        print(json.dumps(dg[name]), flush=True)
    diagnosis_launches = dg["diagnosis_launches"]
    print(json.dumps({"phase": "diagnosis", "gen_s": dg["gen_s"],
                      "diagnosis_launches": diagnosis_launches,
                      "seconds": time.perf_counter() - t}), flush=True)

    # -- the network half of telemetry: the live server's routes during
    # and after main's read, and the CLI against it
    t = time.perf_counter()
    lv = live_phase(dev, main_digests)
    print(json.dumps({**lv, "seconds": time.perf_counter() - t}),
          flush=True)

    # -- the facades: compat v2, the checkpoints, the CLI's kernelbench
    # and workload commands, the kernel build cache
    t = time.perf_counter()
    fc = facades_phase(dev, main_digests, read2_ms)
    print(json.dumps({"phase": "facades", "gen_s": fc["gen_s"],
                      "seconds": time.perf_counter() - t}), flush=True)
    kb_launches = fc["kernelbench"]["launches"]

    flash_launches = {**ua["launches"], **{
        k: n for k, n in ut["launches"].items() if k != "flash_fwd"}}
    flash_entries = [{
        "name": name, "route": "cuda",
        "source": "sparkucx_tpu_torch/csrc/flash_attention.cu",
        "replaces": FLASH_TPU_KERNELS[name],
        "launches": flash_launches[name],
        "transformer_launches_per_step": tf["launches_per_step"][name],
        "max_abs_err": fm["max_abs_err"][name], "ms": fm["kernel_ms"][name],
        "plain_ms": fm["plain_ms"][name],
        "bound_ms": fm["bounds"][name]["bound_ms"],
        "bound_by": fm["bounds"][name]["bound_by"],
        "bound_fp32_simt_ms": fm["bounds"][name]["bound_fp32_simt_ms"],
        "bound_tf32_ms": fm["bounds"][name]["bound_tf32_ms"],
        "library_ms": fm["library"]["forward_ms"] if name == "flash_fwd"
        else fm["library"]["backward_ms"]}
        for name in ("flash_fwd", "flash_dq", "flash_dkv")]

    print(json.dumps({"kernels": [{
        "name": KERNEL_NAME, "route": "cuda",
        "source": "sparkucx_tpu_torch/csrc/ragged_a2a.cu",
        "replaces": TPU_KERNEL, "launches": launches,
        "streaming_launches": stream["launches"],
        "workload_launches": wl_launches[KERNEL_NAME],
        "pipeline_launches": pl_launches[KERNEL_NAME],
        "moe_launches": md["pallas"]["launches"],
        "faults_launches": faults_launches[KERNEL_NAME],
        "integrity_launches": integrity_launches[KERNEL_NAME],
        "tenancy_launches": tenancy_launches[KERNEL_NAME],
        "telemetry_launches": te["telemetry_launches"],
        "diagnosis_launches": diagnosis_launches[KERNEL_NAME],
        "live_launches": lv["live_launches"],
        "compat_launches": fc["compat_v2"]["launches"],
        "checkpoint_launches": fc["checkpoint"]["restored_launches"],
        "max_abs_err": kt["max_abs_err"], "ms": kt["kernel_ms"],
        "plain_ms": kt["plain_ms"], "bound_ms": kt["bound_ms"],
        "bound_by": "bytes", "library_ms": kt["library_ms"]}, {
        "name": SEG_KERNEL, "route": "cuda",
        "source": "sparkucx_tpu_torch/csrc/segment_reduce.cu",
        "replaces": SEG_TPU_KERNEL, "launches": seg_launches,
        "dist_launches": dist_launches[SEG_KERNEL],
        "faults_launches": faults_launches[SEG_KERNEL],
        "integrity_launches": integrity_launches[SEG_KERNEL],
        "tenancy_launches": tenancy_launches[SEG_KERNEL],
        "diagnosis_launches": diagnosis_launches[SEG_KERNEL],
        "workload_launches": wl_launches[SEG_KERNEL],
        "pipeline_launches": pl_launches[SEG_KERNEL],
        "kernelbench_launches": kb_launches.get(SEG_KERNEL, 0),
        "max_abs_err": st["max_abs_err"], "ms": st["kernel_ms"],
        "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
        "bound_full_output_ms": st["bound_full_output_ms"],
        "emit_ms": st["emit_ms"], "tail_ms": st["tail_ms"],
        "bound_by": "bytes", "library_ms": st["library_ms"]}, {
        "name": MERGE_KERNEL, "route": "cuda",
        "source": "sparkucx_tpu_torch/csrc/merge_path.cu",
        "replaces": MERGE_TPU_KERNEL, "launches": merge_launches,
        "dist_launches": dist_launches[MERGE_KERNEL],
        "faults_launches": faults_launches[MERGE_KERNEL],
        "integrity_launches": integrity_launches[MERGE_KERNEL],
        "tenancy_launches": tenancy_launches[MERGE_KERNEL],
        "pipeline_launches": pl_launches[MERGE_KERNEL],
        "max_abs_err": mt["max_abs_err"], "ms": mt["kernel_ms"],
        "plain_ms": mt["plain_ms"], "bound_ms": mt["bound_ms"],
        "bound_by": "bytes", "library_ms": mt["library_ms"]}, {
        "name": QUANT_KERNEL, "route": "cuda",
        "source": "sparkucx_tpu_torch/csrc/quant.cu",
        "replaces": QUANT_TPU_KERNEL,
        "launches": i8_stats["launches"][QUANT_KERNEL],
        "moe_launches": mo["int8_quantize_launches"],
        "hier_launches": hi["hier_int8"]["int8"]["launches"][QUANT_KERNEL],
        "dist_launches": dist_launches[QUANT_KERNEL],
        "faults_launches": faults_launches[QUANT_KERNEL],
        "integrity_launches": integrity_launches[QUANT_KERNEL],
        "max_abs_err": qt["max_abs_err"], "ms": qt["kernel_ms"],
        "plain_ms": qt["plain_ms"], "bound_ms": qt["bound_ms"],
        "bound_by": "bytes", "library_ms": qt["library_ms"]}, {
        "name": WIRE_KERNEL, "route": "cuda",
        "source": "sparkucx_tpu_torch/csrc/segment_reduce.cu",
        "replaces": SEG_TPU_KERNEL,
        "launches": i8_stats["launches"][WIRE_KERNEL],
        "dist_launches": dist_launches[WIRE_KERNEL],
        "kernelbench_launches": kb_launches.get(WIRE_KERNEL, 0),
        "max_abs_err": wt["max_abs_err"], "ms": wt["kernel_ms"],
        "plain_ms": wt["plain_ms"], "bound_ms": wt["bound_ms"],
        "bound_full_output_ms": wt["bound_full_output_ms"],
        "emit_ms": wt["emit_ms"], "tail_ms": wt["tail_ms"],
        "bound_by": "bytes", "library_ms": wt["library_ms"]},
        *flash_entries]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
