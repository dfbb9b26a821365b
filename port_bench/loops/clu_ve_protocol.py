"""The CLU-VE test protocol as the port's learner runs it
(``SingleStepLearner._run_eval_protocol``, the loop of
``SingleStepLearner.test``), unpatched, over an in-memory feed.

Set-up: the learner (the configuration's flags, ``--mode test``,
``--num_test_tasks 1``: each task is its own user), the run's weights
loaded after the port's own weight draw, the frame bank, and the protocol
over the mix's first ``warmup_tasks`` tasks, a whole cycle: every shape the
window uses runs once; the evaluator's MACs counter, which counts each
context size once and then reads its cache, holds every size of the cycle,
as it does after the first of each user's 50 tasks in the CLI's protocol;
and the card's and the pinned host allocators hold a block of every size
the window asks for (a cycle with fewer query frames left the first pin of
each larger query block inside the window: PERF.md).

Window: the protocol over the feed from its first task, whole cycles of
the mix's users, at least ``--seconds``. The benchmark observes it from
outside the loop: an evaluator subclass (the protocol's own timers and
logits, the task boundaries where a traced run starts and stops the
profiler) and a wrapper of the learner's ``predict_fn`` (:class:`Tap`)
whose task state the sampled tasks copy, without a wait, into pinned host
buffers reserved in set-up.

Check: the sampled tasks (the mix's longest and ``sample_tasks`` more
drawn from ``--seed`` among the first cycle) are rebuilt from the seed and
run through the reference; their personalised state and every query
frame's logits are compared.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench import core, roofline, setup
from port_bench.reference import protocol as ref_protocol
from port_bench.trace import Tracer
from port_bench.traffic.feed import EvalFeed, FrameBank, Window, bank_objects

Feed = EvalFeed


def sampled_tasks(mix: dict, seed: int) -> List[int]:
    """Window positions checked: the longest task of the first cycle and
    ``sample_tasks`` others of it drawn from the seed."""
    shapes = mix["tasks"]
    rows = [t["video_frames"] * sum(t["target_videos"]) + sum(t["context_clips"])
            for t in shapes]
    longest = int(np.argmax(rows))
    others = [j for j in range(len(shapes)) if j != longest]
    rng = np.random.default_rng([seed % (1 << 63), 7])
    return sorted([longest] + [int(j) for j in rng.choice(others, mix["sample_tasks"],
                                                          replace=False)])


class Tap:
    """The learner's ``predict_fn``, wrapped: keeps the task state of its
    last call until the task ends. At the end of the first task it sees
    (in set-up) it reserves ``buffers`` sets of host buffers shaped as that
    state, pinned where there is a card, for the sampled tasks' states."""

    def __init__(self, learner, buffers: int):
        self.predict = learner.predict_fn
        self.state = None
        self.count, self.buffers = buffers, None
        learner.predict_fn = self

    def __call__(self, task_state, clips, class_mask):
        self.state = task_state
        return self.predict(task_state, clips, class_mask)

    def task_end(self) -> None:
        if self.buffers is None and self.state is not None:
            self.buffers = [_host_like(self.state) for _ in range(self.count)]
        self.state = None


class Observer:
    """What the benchmark keeps of the window: the sampled tasks' logits and
    states, and the traced span."""

    def __init__(self, sampled, trace: Optional[tuple], tap: Tap):
        self.sampled = set(sampled)
        self.logits: Dict[int, list] = {j: [] for j in sampled}
        self.states: Dict[int, dict] = {}
        self.tap = tap
        self.buffers = dict(zip(sorted(self.sampled), tap.buffers))
        self.trace = trace
        self.tracer = Tracer() if trace else None

    def task_start(self, j: int) -> None:
        if self.tracer is not None and j == self.trace[0]:
            self.tracer.start()

    def video(self, j: int, logits) -> None:
        if j in self.sampled:
            self.logits[j].append(np.asarray(logits))

    def task_end(self, j: int) -> None:
        if j in self.sampled and self.tap.state is not None:
            self.states[j] = _copy_into(self.buffers[j], self.tap.state)
        if self.tracer is not None and j == self.trace[0] + self.trace[1] - 1:
            self.tracer.stop()


def _to_host(x):
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x.detach().cpu() if torch.is_tensor(x) else x


def _host_like(x):
    """Host buffers shaped as ``x``'s tensors, pinned where there is a card."""
    if isinstance(x, dict):
        return {k: _host_like(v) for k, v in x.items()}
    if torch.is_tensor(x):
        return torch.empty(x.shape, dtype=x.dtype, pin_memory=torch.cuda.is_available())
    return x


def _copy_into(buffer, x):
    """``x``'s tensors copied into ``buffer``'s, without waiting for the card
    (read them after a sync)."""
    if isinstance(x, dict):
        return {k: _copy_into(buffer[k], v) for k, v in x.items()}
    if torch.is_tensor(x):
        if buffer.shape != x.shape:
            raise RuntimeError(f"task state leaf {tuple(x.shape)}, buffer {tuple(buffer.shape)}")
        return buffer.copy_(x.detach(), non_blocking=True)
    return x


def make_evaluator(learner, tap: Tap):
    """A test evaluator, as ``SingleStepLearner.init_evaluators`` makes it
    (with the MACs counter) and ``test`` prepares it, that reports to its
    ``observer`` once one is set (:func:`observe`) and ends each task of
    ``tap``."""
    from orbit_tpu_torch.utils.eval_metrics import TestEvaluator

    class Evaluator(TestEvaluator):
        observer: Optional[Observer] = None
        task_index = 0

        def set_task_object_list(self, object_list):
            if self.observer is not None:
                self.observer.task_start(self.task_index)
            super().set_task_object_list(object_list)

        def append_video(self, frame_logits, video_label, frame_paths):
            if self.observer is not None:
                self.observer.video(self.task_index, frame_logits)
            super().append_video(frame_logits, video_label, frame_paths)

        def task_complete(self):
            super().task_complete()
            if self.observer is not None:
                self.observer.task_end(self.task_index)
            tap.task_end()
            self.task_index += 1

    evaluator = Evaluator(learner.evaluation_metrics, learner.checkpoint_dir,
                          with_ops_counter=True)
    evaluator.set_base_params(learner.recogniser)
    return evaluator


def observe(evaluator, observer: Observer):
    """Clear the evaluator's logs, as ``test`` does after a run (its MACs
    counter keeps the counts it cached by shape), and report to
    ``observer`` from task 0."""
    evaluator.reset()
    evaluator.observer, evaluator.task_index = observer, 0
    return evaluator


def run_protocol(learner, feed, evaluator) -> None:
    learner._run_eval_protocol(feed, evaluator, 1, learner.args.test_set, with_timing=True)


def build(run, scratch):
    """Learner with the run's weights, the frame bank and the warm-up;
    returns (learner, its predict tap, the bank, the evaluator)."""
    from orbit_tpu_torch.learners.single_step import SingleStepLearner

    cell, device, mix = run.cell, run.device, run.cell.mix
    phase = setup.Phases(run.started)
    phase("imports")
    bank = FrameBank(mix["frame_bank"], bank_objects(mix), setup.bank_seed(run.seed),
                     device, cell.config["architecture"]["image_size"])
    phase("frame bank")
    model = setup.reference(cell.config, run.seed, device, bank)
    phase("weights")
    args = setup.learner_args(cell.config, "test", scratch, run.seed, ["--num_test_tasks", "1"])
    warm = EvalFeed(mix, bank, run.seed, limit=mix["warmup_tasks"])
    learner = SingleStepLearner(args, test_queue=warm, device=device,
                                after_init=setup.loader(model))
    del model
    tap = Tap(learner, 1 + mix["sample_tasks"])
    phase("learner")
    evaluator = make_evaluator(learner, tap)
    run_protocol(learner, warm, evaluator)
    phase("warm-up cycle (its first task builds or loads the kernels)")
    phase.report()
    return learner, tap, bank, evaluator


def window(run, learner, tap, bank, evaluator, sampled, trace=None):
    """The measured protocol; fills ``run.facts``."""
    mix = run.cell.mix
    observer = Observer(sampled, trace, tap)
    feed = EvalFeed(mix, bank, run.seed)
    feed.window = Window(run.seconds, mix["window_unit_tasks"])
    observe(evaluator, observer)
    setup.sync()
    feed.window.open()
    run.facts["setup_s"] = feed.window.start - run.started
    run_protocol(learner, feed, evaluator)
    feed.window.close()
    run.facts["peak_bytes"] = setup.peak_bytes()
    tasks = feed.handed
    personalise = [t for u in evaluator.all_personalise_times for t in u if not isinstance(t, list)]
    per_frame = [t for u in evaluator.all_inference_times for t in u if not isinstance(t, list)]
    frames = [feed.shape(j)["video_frames"] * sum(feed.shape(j)["target_videos"])
              for j in range(tasks)]
    if len(personalise) != tasks or len(per_frame) != tasks:
        raise RuntimeError(f"{tasks} tasks but {len(personalise)} personalise and "
                           f"{len(per_frame)} inference timings")
    run.facts.update(window_s=feed.window.seconds_measured, tasks=tasks, query_frames=sum(frames),
                     personalise_s=personalise,
                     predict_s=[p * f for p, f in zip(per_frame, frames)])
    if observer.tracer is not None:
        run.trace = observer.tracer.summarise()
        first, count = trace
        run.trace.update(traced_work(run.cell, feed, range(first, first + count)))
    return feed, observer


def traced_work(cell, feed, tasks) -> dict:
    """The traced tasks' summed kernel bounds, model FLOPs and kernel calls,
    from their shapes (``roofline.Work.eval_task``)."""
    batch = int(cell.config["flags"][cell.config["flags"].index("--batch_size") + 1])

    def add(work):
        for j in tasks:
            shape = feed.shape(j)
            work.eval_task(sum(shape["context_clips"]),
                           shape["video_frames"] * sum(shape["target_videos"]),
                           len(shape["context_clips"]), batch)
    return roofline.traced_work(cell.config, add)


def reference_outputs(run, feed, positions, tf32: bool = False, model=None) -> dict:
    """The reference's task state and logits (real classes) for the tasks
    at ``positions``, with TF32 on for the control."""
    from port_bench.reference.precision import tf32 as precision

    device = run.device
    model = model or setup.reference(run.cell.config, run.seed, device, feed.bank)
    out = {}
    with precision(tf32):
        for k in positions:
            task = feed.make(k)
            way = len(feed.shape(k)["context_clips"])
            ctx = torch.from_numpy(task["context_clips"][:, 0]).to(device)
            labels = torch.from_numpy(task["context_labels"]).to(device)
            state = ref_protocol.personalise(model, ctx, labels, 16)
            logits = ref_protocol.predict(model, state, np.concatenate(task["target_clips"]),
                                          way, device)
            out[k] = {"state": _to_host(state), "logits": logits[:, :way], "way": way}
    out["initial"] = {n: p.detach().cpu() for n, p in model.extractor.named_parameters()}
    return out


def gaps(ours: dict, ref: dict) -> Dict[str, float]:
    """The worst relative gap over the tasks of ``ref`` of each compared
    output: logits, and the state (prototypes; or class means, precisions
    and the FiLM values' change from the initial leaves), each over the
    reference's largest magnitude. ``ours``: position -> {"state",
    "logits"} (the program's, or the control's)."""
    numbers: Dict[str, float] = {}

    def worst(name, a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        gap = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        numbers[name] = max(numbers.get(name, 0.0), gap)

    for k, r in ref.items():
        if k == "initial":
            continue
        way, o = r["way"], ours[k]
        worst("logits", np.asarray(o["logits"])[:, :way], r["logits"])
        head, ref_head = o["state"]["head"], r["state"]["head"]
        if "weight" in ref_head:
            worst("prototypes", head["weight"][:way], ref_head["weight"][:way])
        else:
            worst("means", head["means"][:way], ref_head["means"][:way])
            worst("precisions", head["precisions"][:way], ref_head["precisions"][:way])
        if r["state"]["film"] is not None:
            names = sorted(r["state"]["film"])
            initial = torch.cat([ref["initial"][n].reshape(-1) for n in names])
            theirs = torch.cat([r["state"]["film"][n].reshape(-1) for n in names])
            mine = torch.cat([o["state"]["film"][n].reshape(-1) for n in names])
            worst("film", mine - initial, theirs - initial)
    return numbers


def observed(observer) -> dict:
    """The program's outputs of the sampled tasks, as ``gaps`` takes them."""
    return {k: {"state": observer.states[k], "logits": np.concatenate(observer.logits[k])}
            for k in observer.sampled}


def check(run, feed, observer) -> Dict[str, float]:
    """The check's numbers: the program's sampled tasks against the
    reference."""
    return gaps(observed(observer), reference_outputs(run, feed, sorted(observer.sampled)))


def run(run):
    """Set-up, window and check of one run; returns the tasks the window ran."""
    mix = run.cell.mix
    with setup.Scratch() as scratch:
        learner, tap, bank, evaluator = build(run, scratch)
        sampled = sampled_tasks(mix, run.seed)
        trace = tuple(mix["trace_tasks"]) if run.traced else None
        feed, observer = window(run, learner, tap, bank, evaluator, sampled, trace)
        learner.logfile.close()
        del learner
        gc.collect()
        setup.sync()
        t0 = time.perf_counter()
        run.numbers = check(run, feed, observer)
        run.facts["check_s"] = time.perf_counter() - t0
    return run.facts["tasks"]


def readings(cell, args, device, out) -> None:
    """The check's readings (``port_bench/readings.py``): the protocol over
    each seed's sampled tasks alone, at the cell's batch, against the
    reference; the control, the reference in TF32, against the same."""
    started = time.perf_counter()
    run = core.Run(cell, (args.seeds + args.control)[0], 1.0, False, started, device=device)
    with setup.Scratch() as scratch:
        learner, tap, _, evaluator = build(run, scratch)
        for kind, seed_list in (("program", args.seeds), ("control", args.control)):
            for seed in seed_list:
                t0 = time.perf_counter()
                run.seed = seed
                bank = FrameBank(cell.mix["frame_bank"], bank_objects(cell.mix),
                                 setup.bank_seed(seed), device,
                                 cell.config["architecture"]["image_size"])
                model = setup.reference(cell.config, seed, device, bank)
                positions = sampled_tasks(cell.mix, seed)
                feed = EvalFeed(cell.mix, bank, seed, order=positions)
                ks = list(range(len(positions)))
                if kind == "program":
                    learner.recogniser.load_state_dict(model.state_dict())
                    observer = Observer(ks, None, tap)
                    run_protocol(learner, feed, observe(evaluator, observer))
                    setup.sync()
                    numbers = gaps(observed(observer),
                                   reference_outputs(run, feed, ks, model=model))
                else:
                    ours = reference_outputs(run, feed, ks, tf32=True, model=model)
                    numbers = gaps(ours, reference_outputs(run, feed, ks, model=model))
                out[kind][str(seed)] = numbers
                print(f"{kind} seed {seed} tasks {positions}: {numbers} "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
                del model, bank, feed
                gc.collect()
