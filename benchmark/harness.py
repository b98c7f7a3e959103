"""One run of one benchmark cell: set-up, the measured window, the
traced part, the comparison with the reference and the metrics.

Everything that belongs to one configuration, traffic mix or metric is
a file of its own, found by the name that BENCHMARK.json gives:

* configs/<file>.json: the encoder's settings, the content's size and
  the guarantees the stream must keep;
* traffic/<traffic>.json: how the client drives the encoder (the
  content options, the API it calls, chunks, warm-up, the traced part);
* metrics/<metric>.py: a reader `read(run)` that returns the metric's
  value, or None where this run has nothing to read;
* spans/<layer>.json: a function of the program that a traced run
  clocks on the host ({"module": ..., "function": ...}).

The program under test is homerhevc_torch.  The harness takes from it
only the Encoder (and, to judge them, the reconstructions it keeps as
its reference planes), the stage accumulator of
homerhevc_torch.utils.profiler, the functions spans/ names and its
kernels' names; the content, the decoder and the comparison are the
benchmark's own.
"""
from __future__ import annotations

import importlib.util
import json
import os
import resource
import sys
import tempfile
import time

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "homerhevc_tpu")
from frozen import kernel_work, trace_math     # noqa: E402
from frozen.synthetic import synthetic_video   # noqa: E402
from reference import check                    # noqa: E402


class NoChip(RuntimeError):
    pass


def now() -> float:
    return time.perf_counter()


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's,
    its companions' or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_cell(name: str, root: str = ROOT) -> dict:
    """The workload `name` of BENCHMARK.json with its configuration,
    traffic and metric lists resolved by name (under `root`, the
    checkout's root)."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        man = json.load(f)
    bench_dir = os.path.join(root, man["paths"][0])
    wl = next((w for w in man["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == wl["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic",
                           wl["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def mine(ms):
        return [m for m in ms if name in m.get("workloads", [name])]
    return dict(workload=wl, config=config, traffic=traffic,
                bench_dir=bench_dir, end_to_end=mine(man["end_to_end"]),
                per_layer=mine(man["per_layer"]))


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """The `read` function of metrics/<name>.py."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def decide(cell: dict, judged: dict) -> tuple:
    """(correct, {number: {value, limit}}): every compared number at or
    below its limit from the configuration's file."""
    limits = cell["config"]["limits"]
    checks = {k: dict(value=v, limit=limits[k])
              for k, v in judged["readings"].items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def pool_index(i: int, n: int) -> int:
    """Frame i of a pool of n frames played forward, then backward,
    without repeating the turning frames."""
    if n == 1:
        return 0
    j = i % (2 * n - 2)
    return j if j < n else 2 * n - 2 - j


def encoder_config(enc: dict, overrides: dict = None):
    from homerhevc_torch.config import (BitrateMode, EncoderConfig,
                                        PerfMode, RDMode)
    kw = dict(enc, **(overrides or {}))
    enums = dict(rd_mode=RDMode, performance_mode=PerfMode,
                 bitrate_mode=BitrateMode)
    for k, e in enums.items():
        if k in kw:
            kw[k] = e[kw[k]]
    return EncoderConfig(**kw)


class Run:
    """What one run measured; the metric readers read its fields."""

    def __init__(self, cell, seed, seconds, trace):
        self.cell, self.seed, self.seconds, self.trace = \
            cell, seed, seconds, trace
        self.config = cell["config"]
        self.traffic = cell["traffic"]
        self.setup_s = None
        self.window_s = None
        self.frames = 0               # frames of the window
        self.window_bits = 0
        self.dispatch_s = 0.0         # host clock around the API calls
        self.stages = {}              # program stage seconds in the window
        self.sse_y = 0
        self.px_y = 0
        self.traced = None            # the traced part, see _trace_stop
        self.traced_frames = 0
        self.host = {}                # the host's clocks over the window
        self.spans = {}               # layer -> host seconds (Spans)
        self.chunk_s = []             # host seconds of each chunk's calls
        self.memory_peak_bytes = 0
        self.device_kind = None


def _frames_of(t, stacked: bool):
    """The encoder's reference planes after a dispatch, as a stack of
    frames.  After an all-intra chunk (`stacked`) they are the last
    frame of the chunk's stacked reconstruction (an inference tensor,
    which keeps no link to its base): the whole stack is read back from
    the storage the view lies in, when that storage holds exactly the
    chunk's frames and the view is its last."""
    import torch
    hw, off = t.numel(), t.storage_offset()
    if stacked and t.is_contiguous() and off % hw == 0:
        k = off // hw + 1
        if t.untyped_storage().nbytes() == k * hw * t.element_size():
            with torch.inference_mode():
                return torch.empty(0, dtype=t.dtype, device=t.device).set_(
                    t.untyped_storage(), 0, (k,) + tuple(t.shape))
    return t[None]


class _Client:
    """Drives one Encoder through the API the traffic names, keeping
    the coded frames and the reconstructions the encoder predicts from
    (its reference planes after each dispatch)."""

    def __init__(self, enc, source, start: int, stacked: bool):
        self.enc = enc
        self.stacked = stacked
        self.source = source
        self.next = start              # index of the next frame to send
        self.coded = []
        self.recons = {}
        self._last_ref = enc._ref
        self._last_poc = enc._poc

    def _keep_recon(self):
        ref, poc = self.enc._ref, self.enc._poc
        if ref is None or ref is self._last_ref:
            return
        first, self._last_ref, self._last_poc = self._last_poc, ref, poc
        base = [_frames_of(t, self.stacked) for t in ref]
        if base[0].shape[0] == 1:
            self.recons[poc - 1] = tuple(b[0] for b in base)
            return
        for j in range(min(base[0].shape[0], poc - first)):
            self.recons[first + j] = tuple(b[j] for b in base)

    def send(self, api: str) -> float:
        """Sends the next frame; returns the host seconds of the call."""
        y, u, v = self.source(self.next)
        self.next += 1
        t = now()
        if api == "encode":
            out = [self.enc.encode(y, u, v, compute_recon=False)]
        else:
            out = self.enc.encode_async(y, u, v)
        dt = now() - t
        self.coded += out
        self._keep_recon()
        return dt

    def flush(self):
        self.coded += self.enc.flush()
        self._keep_recon()


def _trace_start():
    """Starts the profiler on the device's activity alone: recording the
    host's operations too would multiply the host's time per operation,
    which is what the device's idle share is about."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof, now()


class Spans:
    """Host-clock spans around the calls into the program's layers that
    spans/<layer>.json names ({"module": ..., "function": ...}): each
    call's seconds are added to its layer's total.  The spans wrap the
    module's function in place while the run lasts."""

    def __init__(self, bench_dir: str):
        self.total: dict = {}
        self._saved = []
        d = os.path.join(bench_dir, "spans")
        for f in sorted(os.listdir(d)) if os.path.isdir(d) else []:
            if f.endswith(".json"):
                with open(os.path.join(d, f)) as fh:
                    self._wrap(f[:-5], **json.load(fh))

    def _wrap(self, layer, module, function):
        mod = importlib.import_module(module)
        real = getattr(mod, function)

        def timed(*a, **kw):
            t = now()
            try:
                return real(*a, **kw)
            finally:
                self.total[layer] = self.total.get(layer, 0.0) + now() - t
        self._saved.append((mod, function, real))
        setattr(mod, function, timed)

    def reset(self):
        self.total.clear()

    def close(self):
        while self._saved:
            setattr(*self._saved.pop())


def _trace_stop(prof, t0: float, frames: int, sync) -> dict:
    """Ends the traced part: (name, start_us, end_us) of every device
    operation, and the traced part's host-clock length."""
    sync()
    t1 = now()
    prof.stop()
    t2 = now()
    from torch.autograd import DeviceType
    cuda, dev, names = DeviceType.CUDA, [], {}
    # millions of events: the device's are picked by the cheapest test
    # first, and only they are asked for anything else
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or "annotation" in (
                e.activity_type() if hasattr(e, "activity_type") else ""):
            continue
        a = e.start_ns() / 1e3
        name = e.name()
        dev.append((names.setdefault(name, name), a,
                    a + e.duration_ns() / 1e3))
    return dict(device=dev, wall_s=t1 - t0, frames=frames,
                stop_s=t2 - t1, read_s=now() - t2)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_process: float = None, device: str = "cuda",
             cell: dict = None, encoder_overrides: dict = None,
             log=None) -> tuple:
    """Runs the cell; returns (Run, judged) where judged is what
    reference.check.judge returned."""
    t_process = now() if t_process is None else t_process
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    cell = cell or load_cell(name)
    import torch
    chips = cell["workload"]["chips"]
    on_cuda = device == "cuda"
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if on_cuda and found < chips:
        raise NoChip(f"the cell needs {chips} CUDA device(s); found {found}")
    if on_cuda:
        # the program's host work is one dispatching thread and one
        # entropy worker; idle CPU thread pools only add noise
        torch.set_num_threads(1)

    run = Run(cell, seed, seconds, trace)
    conf, tr = cell["config"], cell["traffic"]
    h, w = conf["video"]["height"], conf["video"]["width"]
    pool = synthetic_video(tr["pool_frames"], h, w,
                           seed=seed % (1 << 63), **tr["content"])

    def source(i):
        return pool[pool_index(i, len(pool))]

    def sync():
        if on_cuda:
            torch.cuda.synchronize()

    t_content = now()
    client, intro = _start_stream(conf, tr, source, device,
                                  encoder_overrides)
    t_stream = now()
    for _ in range(tr["warm_frames"]):
        client.send(tr["api"])
    client.flush()
    sync()
    t_warm = now()
    log(f"[bench] set-up {t_warm - t_process:.2f}s: to the content "
        f"{t_content - t_process:.2f}s, stream start ({len(intro)} intro "
        f"frame(s)) {t_stream - t_content:.2f}s, warm-up "
        f"{t_warm - t_stream:.2f}s")
    spans = Spans(cell["bench_dir"]) if trace else None
    try:
        coded, frames, due = _window(run, client, intro, sync, spans,
                                     log, t_process)
    finally:
        if spans is not None:
            spans.close()
    if on_cuda:
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        run.device_kind = torch.cuda.get_device_name(0)
    recons = {i: tuple(p.to("cpu").numpy().astype(np.uint8)[
        :s.shape[0], :s.shape[1]] for p, s in zip(planes, source(i)))
        for i, planes in client.recons.items()}
    client.enc._worker.shutdown(wait=True)
    del client
    if on_cuda:
        torch.cuda.empty_cache()
    t = now()
    judged = check.judge([f.nalus for f in coded], source, recons, frames,
                         conf["guarantees"], due)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    log(f"[bench] reference check {now() - t:.2f}s; host memory peak "
        f"{rss:.2f} GiB")
    run.sse_y, run.px_y = judged["sse_y"], judged["px_y"]
    return run, judged


def _start_stream(conf, tr, source, device, overrides) -> tuple:
    """The Encoder the window drives, and the frames coded before it:
    where the configuration names an "intro", the stream's I frame,
    coded by a second Encoder of those settings and handed over as a
    checkpoint (in TMPDIR)."""
    from homerhevc_torch.api import Encoder
    enc = Encoder(encoder_config(conf["encoder"], overrides), device=device)
    if not conf.get("intro"):
        return _Client(enc, source, 0, tr["shape"] == "chunks"), []
    icfg = encoder_config(conf["encoder"],
                          dict(overrides or {}, **conf["intro"]))
    ienc = Encoder(icfg, device=device)
    fr = ienc.encode(*source(0), compute_recon=False)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "intro.npz")
        ienc.save_checkpoint(path)
        enc.load_checkpoint(path)
    ienc._worker.shutdown(wait=True)
    client = _Client(enc, source, 1, tr["shape"] == "chunks")
    client.recons[0] = ienc._ref
    return client, [fr]


def _host_clocks() -> dict:
    """The host's own clocks, read around the window to tell a slower
    host from more work: this thread's and the process's CPU seconds,
    involuntary context switches, and the machine's stolen CPU time
    (/proc/stat, where there is one)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    steal = 0.0
    try:
        with open("/proc/stat") as f:
            cpu = f.readline().split()
        steal = int(cpu[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return dict(wall=now(), thread=time.thread_time(),
                process=time.process_time(), nivcsw=ru.ru_nivcsw,
                steal=steal)


def _traced_part(run, client, api: str, n: int, sync, log):
    """A traced run's traced part, before the window: n frames under the
    device profiler, then the encoder drained, so that the window after
    it runs unprofiled and the host-clock layers read it alone."""
    prof, p0 = _trace_start()
    for _ in range(n):
        client.send(api)
    run.traced = _trace_stop(prof, p0, n, sync)
    del prof
    client.flush()
    run.traced_frames = n
    log(f"[bench] traced {n} frames in {run.traced['wall_s']:.2f}s: "
        f"{len(run.traced['device'])} device operations; profiler stop "
        f"{run.traced['stop_s']:.2f}s, read {run.traced['read_s']:.2f}s")


def _window(run, client, intro, sync, spans, log,
            t_process: float) -> tuple:
    """The measured window, after a traced run's traced part (its first
    trace_frames frames).  Returns every coded frame of the stream, the
    frame indices of the traced part and the window, and those of them
    whose reconstruction the encoder must have handed over: every frame
    of an all-intra chunk, the last frame of each P chunk."""
    from homerhevc_torch.utils import profiler as stages
    tr = run.traffic
    api, seconds = tr["api"], run.seconds
    enc_cfg = client.enc.cfg
    chunked = tr["shape"] == "chunks"
    chunk = enc_cfg.intra_frames_per_launch if chunked else \
        (enc_cfg.frames_per_launch if api == "encode_async" else 1)
    first, n_before = client.next, len(client.coded)
    if run.trace and tr["trace_frames"]:
        _traced_part(run, client, api, tr["trace_frames"], sync, log)
    stages.reset()
    if spans is not None:
        spans.reset()
    h0 = _host_clocks()
    t_start = h0["wall"]
    run.setup_s = t_start - t_process
    last_chunk = 0.0
    while run.frames == 0 or (
            now() - t_start + last_chunk <= seconds if chunked
            else now() - t_start < seconds):
        c0 = now()
        for _ in range(chunk):
            run.dispatch_s += client.send(api)
            run.frames += 1
        last_chunk = now() - c0
        run.chunk_s.append(last_chunk)
    client.flush()
    h1 = _host_clocks()
    run.window_s = h1["wall"] - t_start
    run.host = {k: h1[k] - h0[k] for k in h0}
    run.stages = dict(getattr(stages, "_acc", {}))
    if spans is not None:
        run.spans = dict(spans.total)
    c = run.chunk_s
    log(f"[bench] window {run.window_s:.2f}s: {run.frames} frames in "
        f"{len(c)} chunks of {chunk}; first chunks "
        f"{', '.join(f'{x:.3f}' for x in c[:3])} s, median "
        f"{float(np.median(c)):.3f} s; CPU s: this thread "
        f"{run.host['thread']:.2f}, process {run.host['process']:.2f}; "
        f"involuntary switches {run.host['nivcsw']}; machine's stolen "
        f"CPU s {run.host['steal']:.2f}")
    coded = intro + client.coded
    n_run = len(client.coded) - n_before
    run.window_bits = sum(8 * len(f.nalus)
                          for f in coded[len(coded) - run.frames:])
    frames = range(first, first + n_run)
    due = frames if chunked else range(first + chunk - 1, frames.stop,
                                       chunk)
    return coded, frames, due


def metrics_of(run: Run, specs: list) -> dict:
    """{name: {value, unit}} of each metric in `specs` that this run has
    something to read for."""
    out = {}
    for m in specs:
        v = metric_reader(m["name"], run.cell["bench_dir"])(run)
        if v is not None:
            out[m["name"]] = dict(value=v, unit=m["unit"])
    return out


def op_label(name: str, n: int = 80) -> str:
    """A device operation's name without its namespaces, cut to n."""
    if name.startswith("void "):
        name = name[5:]
    for ns in ("(anonymous namespace)::", "at::native::", "at::", "c10::",
               "std::"):
        name = name.replace(ns, "")
    return name[:n]


def breakdown(traced: dict) -> dict:
    """The traced part's ten device operations with the most time, and
    its ten longest idle gaps, each named by the device operations on
    either side of it (the host is not traced: see _trace_start)."""
    dev = sorted(traced["device"], key=lambda e: e[1])
    top = trace_math.top_by_time(dev)[:10]
    spans = [(a, b) for _, a, b in dev]
    if not spans:
        return dict(device_ops=[], idle_gaps=[])
    t0, t1 = spans[0][0], max(b for _, b in spans)
    ends = sorted((b, n) for n, _, b in dev)
    end_t = np.array([e for e, _ in ends])
    starts = np.array([a for a, _ in spans])
    gaps = []
    for a, b in trace_math.idle_gaps(spans, t0, t1)[:10]:
        k = int(np.searchsorted(end_t, a, side="right")) - 1
        j = int(np.searchsorted(starts, b, side="left"))
        before = op_label(ends[k][1], 38) if k >= 0 else "start"
        after = op_label(dev[j][0], 38) if j < len(dev) else "end"
        gaps.append([f"{before} -> {after}", (b - a) / 1e6])
    return dict(device_ops=[[op_label(n), t / 1e6] for n, t in top],
                idle_gaps=gaps)


def kernel_least_ms(config: dict) -> dict:
    """Per wrapper of homerhevc_torch.ops.kernels, the least milliseconds
    of one P frame's calls at the configuration's shapes."""
    enc = config["encoder"]
    h, w = config["video"]["height"], config["video"]["width"]
    ctu = enc.get("cu_size", 64)
    cfg = dict(padded_height=-h % ctu + h, padded_width=-w % ctu + w,
               num_ref_frames=enc.get("num_ref_frames", 1),
               rd_mode=enc.get("rd_mode", "RD_FAST"),
               intra_in_p=enc.get("intra_in_p", True))
    return kernel_work.least_ms(cfg)


def kernel_share(run, stem: str, wrappers: tuple):
    """The share of its roofline, in %, of the CUDA kernel whose device
    name starts with `stem`: the least time of the calls of `wrappers`
    in one P frame, over the kernel's device time per frame in the
    traced part.  None where the traced part ran no such kernel."""
    t = run.traced
    if t is None:
        return None
    dev_us = sum(b - a for n, a, b in t["device"]
                 if op_label(n).startswith(stem))
    if dev_us <= 0:
        return None
    least = kernel_least_ms(run.config)
    return 100.0 * sum(least[k] for k in wrappers) / (dev_us / 1e3
                                                      / t["frames"])
