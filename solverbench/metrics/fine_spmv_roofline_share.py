"""The cell's fine operator in its own precision (the configuration's
``fine32``), applied alone at the cell's shape: ``APPLIES`` applies, each
timed by CUDA events with the L2 cache flushed before it by writing a
buffer of ``FLUSH_BYTES``; the median time against the least time the
bytes of the product take at the device's peak bandwidth
(``roofline.spmv_min_bytes``: x read once, y written once)."""
import sys

from solverbench import roofline

APPLIES = 300
CHUNK = 25                      # applies queued behind one sleep
FLUSH_BYTES = 128 << 20         # over twice the H100's 50 MB L2
SLEEP_CYCLES = 20_000_000       # about 10 ms: the host queues a chunk


def measure(run):
    import torch
    if run.device.type != "cuda":
        return
    bw = roofline.peak(run.kind, "hbm_bytes_per_s")
    if bw is None:
        return
    op, dtype = run.system.fine_operators()["fine32"]
    x = torch.as_tensor(run.sample_x(), device=run.device).to(dtype)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                        device=run.device)
    op(x)
    times = []
    for _ in range(APPLIES // CHUNK):
        if hasattr(torch.cuda, "_sleep"):
            torch.cuda._sleep(SLEEP_CYCLES)
        evs = []
        for _ in range(CHUNK):
            flush.fill_(1.0)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            op(x)
            b.record()
            evs.append((a, b))
        torch.cuda.synchronize(run.device)
        times += [a.elapsed_time(b) / 1e3 for a, b in evs]
    times.sort()
    med = times[len(times) // 2]
    n = x.numel()
    least = roofline.spmv_min_bytes(n, n, x.element_size()) / bw
    run.extra["fine_spmv"] = roofline.share(least, med)
    print(f"fine_spmv: {len(times)} applies, median {med * 1e6:.3f} us "
          f"(min {times[0] * 1e6:.3f}, max {times[-1] * 1e6:.3f}), least "
          f"{least * 1e6:.3f} us at {bw / 1e12} TB/s; card {run.card}",
          file=sys.stderr)


def read(run):
    return run.extra.get("fine_spmv")
