"""Series-by-series comparison of the JAX package's and the port's metrics
registries after the same serving schedule (``tests/test_torch_*``
observability tests).

Engine and pool ids are process-wide counters in each package, so the
``engine`` / ``pool`` labels are renamed by the order the caller lists the
ids in.  Some families differ by design and are left out:

  * ``jit.traces``: the reference counts jit traces, the port builds
    (the chunked engine's decode step, one prefill build a (bucket, rows)
    key, labelled apart);
  * ``ops.kernel_path``: the reference counts once per trace under its
    route names, the port once per call under ``kernel`` / ``plain``;
  * ``serving.perf_anomalies``: EWMA detections on wall-clock streams;
  * the reference's ``kernels.predicted_*`` gauges, its static pre-flight
    of the Pallas kernels' VMEM and streamed bytes (no counterpart);
  * the port's own ``serving.mixed_step_ms`` and
    ``serving.prefill_wave_ms``.

Histograms of wall-clock times (:data:`TIMING`) compare by count; every
other series compares whole (value, or count, sum, percentiles and
buckets).
"""

TIMING = ("serving.queue_wait_ms", "serving.ttft_ms", "serving.tpot_ms",
          "serving.decode_step_ms", "perf.tick_model_ratio")
BY_DESIGN = ("jit.traces", "ops.kernel_path", "serving.perf_anomalies",
             "kernels.predicted_streamed_bytes",
             "kernels.predicted_vmem_bytes",
             "serving.mixed_step_ms", "serving.prefill_wave_ms")


def series(snap, engines=(), pools=()):
    """``snapshot()`` -> {family: [rows]} with the ``engine`` / ``pool``
    labels renamed to ``e<i>`` / ``p<i>`` by their place in ``engines`` /
    ``pools`` (ids not listed are kept), :data:`TIMING` rows cut to their
    labels and count, :data:`BY_DESIGN` families dropped."""
    ren = {"engine": {str(e): f"e{i}" for i, e in enumerate(engines)},
           "pool": {str(p): f"p{i}" for i, p in enumerate(pools)}}
    out = {}
    for name, fam in snap.items():
        if name == "schema_version" or name in BY_DESIGN:
            continue
        rows = []
        for r in fam["series"]:
            labels = {k: ren.get(k, {}).get(v, v)
                      for k, v in r["labels"].items()}
            if name in TIMING:
                r = {"count": r["count"]}
            rows.append(dict(r, labels=labels))
        rows.sort(key=lambda r: sorted(r["labels"].items()))
        out[name] = {"type": fam["type"], "help": fam["help"],
                     "series": rows}
    return out


def assert_same_series(jax_snap, port_snap, jax_ids, port_ids):
    """The two snapshots' series equal family by family, engine ids
    ``jax_ids`` / ``port_ids`` (and pool ids, as ``(engines, pools)``)
    matched in order."""
    want = series(jax_snap, *jax_ids)
    got = series(port_snap, *port_ids)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
