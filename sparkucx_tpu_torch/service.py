"""Config-keyed facade: :func:`connect` builds node + manager from a flat
conf mapping, so an engine drives shuffles without touching any internal
constructor.

``spark.shuffle.tpu.io.format`` picks the codec. ``raw`` (the port's
default): ``write`` takes int64 keys and optional value rows, ``read``
returns the partition view (plain, combined by key or key-ordered), or
the device result under ``sink="device"``. ``arrow``: ``write`` takes
RecordBatches (the ``io.keyColumn`` column routes, the rest ride;
``io.stringMaxBytes`` caps a string column) and ``read`` returns one
RecordBatch per non-empty partition (``io/arrow.py``). The JAX package
defaults to ``arrow``; the port keeps ``raw``, because pyarrow is an
optional dependency the card's machine lacks.

``spark.shuffle.tpu.compat.version`` picks the facade :func:`connect`
returns: ``v1`` (this module's :class:`ShuffleService`, the default) or
``v2`` (``compat/v2.py``: dependency-object registration, attempt-id
writers, partition-range readers).

``read_async`` / ``submit_async`` run reads on the async plane
(``shuffle/tenancy.AsyncShuffleExecutor``) and return a
``ShuffleFuture``; ``register_shuffle(tenant=)`` names the tenant a
shuffle's reads run as (``tenant.*`` keys).

``stats(format="json"|"prometheus")`` is one snapshot of the telemetry
plane (``Node.telemetry_snapshot`` with the manager's exchange
reports): the dict, or its Prometheus text exposition. Under
``metrics.dumpDir`` a ``utils/export.PeriodicDumper`` writes it every
``metrics.dumpIntervalSecs``; its beat also rolls the history windows
when ``history.dir`` or an SLO objective is set (a tick-only dumper
without a dump dir). ``doctor(format="findings"|"json"|"text")`` runs the
doctor (``utils/doctor.py``) over that snapshot; ``slo(format="json"|
"text")`` is the node's SLO verdict (``utils/slo.py``). The node's
``telemetry_provider`` / ``doctor_provider`` (what its doctor watcher
reads) serve this service's ``stats`` and ``doctor`` until ``stop``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from sparkucx_tpu_torch.config import ShuffleConf
from sparkucx_tpu_torch.runtime.node import DEFAULT_SHARDS, Node
from sparkucx_tpu_torch.shuffle.manager import ShuffleHandle, ShuffleManager
from sparkucx_tpu_torch.shuffle.tenancy import (AsyncShuffleExecutor,
                                                ShuffleFuture)
from sparkucx_tpu_torch.utils.doctor import diagnose, render_findings
from sparkucx_tpu_torch.utils.export import PeriodicDumper, render_prometheus
from sparkucx_tpu_torch.utils.slo import render_verdict

IO_FORMATS = ("arrow", "raw")


def _start_dumper(conf: ShuffleConf, stats_fn, node) -> Optional[
        PeriodicDumper]:
    """The periodic snapshot dumper (``metrics.dumpDir``, every
    ``metrics.dumpIntervalSecs``), whose beat also ticks the node's
    history when ``history.dir`` or an SLO objective is set; a tick-only
    dumper (no dump dir) then beats at the history window. None when
    none is set."""
    dump_dir = conf.metrics_dump_dir
    dump_interval = conf.metrics_dump_interval_secs
    interval = dump_interval
    ticks = []
    if node.history.out_dir or node.slo_objectives:
        ticks.append(node.history.tick)
        interval = min(interval, node.history.window_secs)
    if not dump_dir and not ticks:
        return None
    # the thread beats at the faster cadence; the file still lands at
    # the configured dump rate
    dump_every = max(1, round(dump_interval / interval))
    return PeriodicDumper(lambda: stats_fn("json"), dump_dir, interval,
                          tick_fns=ticks, dump_every=dump_every).start()


class ShuffleService:
    """The assembled stack behind one :func:`connect` call: register /
    write / read / unregister / stop, and the async reads."""

    def __init__(self, conf: ShuffleConf, device=None,
                 num_shards: int = DEFAULT_SHARDS, distributed: bool = False,
                 process_id: int = 0, metrics_reporter=None):
        self.conf = conf
        self.io_format = (conf.get("spark.shuffle.tpu.io.format") or "raw") \
            .strip().lower()
        if self.io_format not in IO_FORMATS:
            raise ValueError(f"unknown io.format {self.io_format!r}; want "
                             f"{IO_FORMATS}")
        if self.io_format == "arrow":
            from sparkucx_tpu_torch.io.arrow import _require_arrow
            _require_arrow()
        self.key_column = conf.get("spark.shuffle.tpu.io.keyColumn", "key")
        # per-record ceiling of a string/binary Arrow column (the varlen
        # pad width, io/varlen.py): part of the shuffle's schema
        self.string_max_bytes = int(conf.get(
            "spark.shuffle.tpu.io.stringMaxBytes", "64"))
        self.node = Node.start(conf, device=device, num_shards=num_shards,
                               distributed=distributed,
                               process_id=process_id)
        self.manager = ShuffleManager(self.node, conf)
        # the host engine's metrics seam: fn(name, value) sees every
        # counter increment
        self._metrics_reporter = metrics_reporter
        if metrics_reporter is not None:
            self.node.metrics.add_reporter(metrics_reporter)
        # the async plane (its worker pool starts on the first submit);
        # it shares the manager's tenant registry, and reports stamp its
        # effective width
        self._async = AsyncShuffleExecutor(
            conf, self.manager._tenants, self.node.metrics,
            distributed=self.node.is_distributed)
        self.manager._async_workers = self._async.workers
        self._dumper = _start_dumper(conf, self.stats, self.node)
        # the node's watcher reads this service's richer pair (exchange
        # reports included); stop() restores the node's own
        self.node.telemetry_provider = lambda: self.stats("json")
        self.node.doctor_provider = lambda: self.doctor("findings")

    @property
    def device(self):
        return self.node.device

    def register_shuffle(self, shuffle_id: int, num_maps: int,
                         num_partitions: int, partitioner: str = "hash",
                         bounds=None,
                         tenant: Optional[str] = None) -> ShuffleHandle:
        return self.manager.register_shuffle(shuffle_id, num_maps,
                                             num_partitions, partitioner,
                                             bounds, tenant=tenant)

    def unregister_shuffle(self, shuffle_id: int) -> None:
        self.manager.unregister_shuffle(shuffle_id)

    def write(self, handle: ShuffleHandle, map_id: int, data,
              values: Optional[np.ndarray] = None) -> None:
        """Stage and commit one map task's output. raw: ``data`` is the
        int64 keys (+ optional values); arrow: a RecordBatch or a list of
        them."""
        if self.io_format == "arrow":
            from sparkucx_tpu_torch.io.arrow import write_batches
            batches = data if isinstance(data, (list, tuple)) else [data]
            write_batches(self.manager, handle, map_id, batches,
                          self.key_column,
                          string_max_bytes=self.string_max_bytes)
            return
        w = self.manager.get_writer(handle, map_id)
        w.write(np.asarray(data), values)
        w.commit(handle.num_partitions)

    def writer(self, handle: ShuffleHandle, map_id: int):
        """Raw incremental writer for multi-batch map tasks (both formats;
        arrow callers convert with ``io.arrow.batch_to_kv``)."""
        return self.manager.get_writer(handle, map_id)

    def read(self, handle: ShuffleHandle, timeout: Optional[float] = None,
             combine: Optional[str] = None, ordered: bool = False,
             combine_sum_words: int = 0, sink: Optional[str] = None):
        """The partition view, or with ``sink="device"`` the device result
        (see :meth:`ShuffleManager.read` for ``combine`` / ``ordered`` /
        ``sink``); under ``io.format=arrow`` one RecordBatch per
        non-empty partition."""
        if self.io_format == "arrow":
            if sink == "device":
                raise ValueError(
                    "sink='device' requires io.format=raw: the Arrow "
                    "egress materializes RecordBatches host-side by "
                    "definition — the round-trip the device sink deletes")
            from sparkucx_tpu_torch.io.arrow import read_batches
            return read_batches(self.manager, handle,
                                key_column=self.key_column, timeout=timeout,
                                ordered=ordered, combine=combine,
                                combine_sum_words=combine_sum_words)
        return self.manager.read(handle, timeout=timeout, combine=combine,
                                 ordered=ordered,
                                 combine_sum_words=combine_sum_words,
                                 sink=sink)

    def submit(self, handle: ShuffleHandle,
               timeout: Optional[float] = None,
               combine: Optional[str] = None, ordered: bool = False,
               combine_sum_words: int = 0, sink: Optional[str] = None):
        return self.manager.submit(handle, timeout=timeout, combine=combine,
                                   ordered=ordered,
                                   combine_sum_words=combine_sum_words,
                                   sink=sink)

    def read_async(self, handle: ShuffleHandle, **kw) -> ShuffleFuture:
        """:meth:`read` on the async plane: a future of what
        ``read(handle, **kw)`` returns. A tenant at its
        ``tenant.<id>.maxInflightReads`` blocks here until one of its
        reads resolves. On a distributed node every process submits the
        same reads in the same order; each batch's order is agreed
        collectively (see ``AsyncShuffleExecutor``)."""
        return self._async.submit(lambda: self.read(handle, **kw),
                                  handle.tenant, handle.shuffle_id,
                                  timeout=kw.get("timeout"))

    def submit_async(self, handle: ShuffleHandle, **kw) -> ShuffleFuture:
        """:meth:`submit` and its ``result()`` on the async plane, under
        :meth:`read_async`'s caps and order; like ``submit`` it does not
        replay."""
        def run():
            return self.manager.submit(handle, **kw).result()
        return self._async.submit(run, handle.tenant, handle.shuffle_id,
                                  timeout=kw.get("timeout"))

    def report(self, shuffle_id: int):
        return self.manager.report(shuffle_id)

    def recovered_shuffles(self):
        """The shuffles the durable ledger (``failure.ledgerDir``)
        recovered at connect that are not re-registered yet:
        ``{shuffle_id: {"intact": [...], "quarantined": [...]}}``.
        ``register_shuffle`` with the same shape adopts one; only its
        quarantined maps need writing again."""
        return self.manager.recovered_shuffles()

    def stats(self, format: str = "json"):
        """One snapshot of the telemetry plane: counters, histograms
        (with p50/p99), gauges, the span summary and the exchange
        reports. ``"json"``: the snapshot dict; ``"prometheus"``: its
        text exposition."""
        doc = self.node.telemetry_snapshot(
            reports=self.manager.exchange_reports())
        if format == "json":
            return doc
        if format == "prometheus":
            return render_prometheus(doc)
        raise ValueError(f"unknown stats format {format!r}; "
                         f"want json|prometheus")

    def doctor(self, format: str = "findings"):
        """The doctor over this service's :meth:`stats` document:
        ``"findings"`` (``utils/doctor.Finding`` objects), ``"json"``
        (their dicts) or ``"text"``."""
        findings = diagnose(self.stats("json"))
        if format == "findings":
            return findings
        if format == "json":
            return [f.to_dict() for f in findings]
        if format == "text":
            return render_findings(findings)
        raise ValueError(f"unknown doctor format {format!r}; "
                         f"want findings|json|text")

    def slo(self, format: str = "json"):
        """The SLO verdict over the retained history windows
        (``Node.slo_verdict``; objectives from ``slo.*`` and
        ``tenant.<id>.slo.*``): the dict (``"json"``) or ``"text"``."""
        verdict = self.node.slo_verdict()
        if format == "json":
            return verdict
        if format == "text":
            return render_verdict(verdict)
        raise ValueError(f"unknown slo format {format!r}; want json|text")

    def stop(self) -> None:
        # async reads in flight hold pinned blocks and reservations of the
        # manager stopped next: drain them first
        self._async.stop()
        if self._dumper is not None:
            # its stop writes the final snapshot
            self._dumper.stop()
            self._dumper = None
        if self._metrics_reporter is not None:
            self.node.metrics.remove_reporter(self._metrics_reporter)
            self._metrics_reporter = None
        # the watcher must not keep reading through a stopped manager
        self.node.reset_providers()
        self.manager.stop()
        self.node.close()

    close = stop

    def __enter__(self) -> "ShuffleService":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def connect(conf: Optional[Mapping[str, str]] = None, *, device=None,
            num_shards: int = DEFAULT_SHARDS, distributed: bool = False,
            process_id: int = 0, use_env: bool = True,
            metrics_reporter=None):
    """Build the stack purely from configuration. ``device`` defaults to
    the CUDA device and raises without one; ``device="cpu"`` is the only
    way to run without a GPU. ``num_shards`` is the number of logical
    shards the exchange splits the device into (distributed: the GLOBAL
    count, split evenly over the processes). ``distributed=True`` joins
    the cluster of ``numProcesses`` processes at ``coordinator.address``
    as process ``process_id``; its reads are collectives
    (``shuffle/distributed.py``). ``metrics_reporter`` — optional
    ``fn(name, value)`` seeing every shuffle counter increment.
    ``compat.version`` selects the facade class (``compat/``): ``v1``
    (:class:`ShuffleService`, the default) or ``v2``; an unknown version
    raises here."""
    tconf = conf if isinstance(conf, ShuffleConf) \
        else ShuffleConf(conf, use_env=use_env)
    from sparkucx_tpu_torch.compat import resolve_adapter
    cls = resolve_adapter(
        tconf.get("spark.shuffle.tpu.compat.version", "v1"))
    return cls(tconf, device=device, num_shards=num_shards,
               distributed=distributed, process_id=process_id,
               metrics_reporter=metrics_reporter)
