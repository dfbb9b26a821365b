"""LITE meta-training as the port's learner runs it
(``SingleStepLearner.train``), unpatched, over an in-memory feed.

One ``train()`` call runs set-up and window alike, so the step that the
window measures is the object set-up built and drove: the learner (the
configuration's flags and ``train_flags``, one epoch), the run's weights
loaded after the port's own weight draw, then the mix's first
``setup_tasks`` task steps (two Adam updates at 16 tasks a batch), which
warm the step up and which the check follows. The window opens when the
second update returns, and closes when the epoch's loop ends (the feed
stops at whole update batches past ``--seconds``); the epoch's checkpoint
is written after it.

The benchmark observes the loop from outside: a train evaluator subclass
(each step's logits, the task boundaries where a traced run starts the
profiler), and optimizer step hooks (the first update's gradients, the
parameters after the second, the window's opening, the traced span's end).

Check: the reference runs the set-up's steps again from the seed; each
step's logits and loss, every leaf's gradient norm at the first update and
every leaf's change over the two updates are compared.
"""
from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.optim.optimizer as optim_hooks

from port_bench import core, roofline, setup
from port_bench.reference import lite
from port_bench.trace import Tracer
from port_bench.traffic.feed import FrameBank, TrainFeed, Window, bank_objects

Feed = TrainFeed


class Observer:
    def __init__(self, learner, setup_tasks: int, unit: int, window: Window,
                 trace: Optional[tuple]):
        self.named = list(learner.recogniser.named_parameters())
        self.names = {id(p): n.split(".", 1)[1] for n, p in self.named
                      if n.startswith("extractor.")}
        self.setup_tasks, self.unit, self.window = setup_tasks, unit, window
        self.trace = trace
        self.tracer = Tracer() if trace else None
        self.steps = 0
        self.updates = 0
        self.logits: List[np.ndarray] = []
        self.grad_norms: Dict[str, float] = {}
        self.params: Dict[str, torch.Tensor] = {}
        self.peak = 0
        self.peaks: List[tuple] = []    # (task steps done, GiB) where the peak grew

    def step_end(self, logits) -> None:
        if self.steps < self.setup_tasks:
            self.logits.append(np.array(logits, copy=True))
        self.steps += 1
        peak = setup.peak_bytes()
        if peak > self.peak:
            self.peak = peak
            self.peaks.append((self.steps, round(peak / 2 ** 30, 4)))
        if self.steps > self.setup_tasks and self.window.start is None:
            self.end_setup(self.optimizer_params())  # the set-up's updates never came
        if self.tracer is not None and self.steps == self.setup_tasks + self.trace[0]:
            self.tracer.start()

    def optimizer_params(self):
        return [p for n, p in self.named if n.startswith("extractor.")]

    def end_setup(self, params) -> None:
        """Keep the parameters the set-up left and open the window."""
        self.params = {self.names[id(p)]: p.detach().to("cpu", copy=True) for p in params}
        setup.sync()
        self.window.open()

    def pre_step(self, optimizer, args, kwargs) -> None:
        if self.updates == 0:
            named = [(self.names[id(p)], p) for group in optimizer.param_groups
                     for p in group["params"] if id(p) in self.names and p.grad is not None]
            norms = torch.stack([p.grad.detach().norm() for _, p in named]).cpu().tolist()
            self.grad_norms = {n: v for (n, _), v in zip(named, norms)}

    def post_step(self, optimizer, args, kwargs) -> None:
        self.updates += 1
        if self.updates * self.unit == self.setup_tasks:
            self.end_setup([p for group in optimizer.param_groups for p in group["params"]
                            if id(p) in self.names])
        if (self.tracer is not None and self.tracer.running
                and self.steps >= self.setup_tasks + self.trace[0] + self.trace[1]):
            self.tracer.stop()


def make_evaluator(learner, observer: Observer):
    from orbit_tpu_torch.utils.eval_metrics import TrainEvaluator

    class Evaluator(TrainEvaluator):
        def update_stats(self, logits, labels):
            observer.step_end(logits)
            super().update_stats(logits, labels)

    return Evaluator(learner.evaluation_metrics)


def train_settings(config: dict, args) -> dict:
    """The update the learner makes at epoch 0 (its schedule's first rate)
    and the LITE settings, from its parsed arguments."""
    from orbit_tpu_torch.utils.optim import make_lr_schedule

    return {"lr": make_lr_schedule(args)(0), "betas": list(args.betas), "eps": args.epsilon,
            "weight_decay": args.weight_decay, "num_lite_samples": args.num_lite_samples,
            "tasks_per_batch": args.tasks_per_batch, "batch_size": args.batch_size,
            "learn_extractor": args.learn_extractor}


def refuse_unless_driven(config: dict) -> None:
    """This loop and its reference (``reference/lite.py``) drive ProtoNets
    LITE with the extractor learned on a backbone without BatchNorm; any
    other configuration needs a loop module of its own."""
    a = config["architecture"]
    if (a["classifier"] != "proto" or a["adapt_features"] or a["backbone"] != "vit"
            or "--learn_extractor" not in config["train_flags"]):
        raise core.Refused(f"lite_meta_train drives ProtoNets LITE with a learned ViT "
                           f"extractor only, not {config['name']}: its mix names another loop")


def run(run):
    """Set-up, window and check of one run; returns the tasks the window ran."""
    from orbit_tpu_torch.learners.single_step import SingleStepLearner

    cell, device, mix = run.cell, run.device, run.cell.mix
    refuse_unless_driven(cell.config)
    phase = setup.Phases(run.started)
    phase("imports")
    with setup.Scratch() as scratch:
        bank = FrameBank(mix["frame_bank"], bank_objects(mix), setup.bank_seed(run.seed), device,
                         cell.config["architecture"]["image_size"])
        phase("frame bank")
        model = setup.reference(cell.config, run.seed, device, bank)
        phase("weights")
        args = setup.learner_args(cell.config, "train", scratch, run.seed,
                                  cell.config["train_flags"])
        feed = TrainFeed(mix, bank, run.seed)
        learner = SingleStepLearner(args, train_queue=feed, device=device,
                                    after_init=setup.loader(model))
        del model
        phase("learner")
        setup.discard_checkpoints(learner)
        settings = train_settings(cell.config, args)
        unit = settings["tasks_per_batch"]
        window = Window(run.seconds, mix["window_unit_tasks"], before=mix["setup_tasks"])
        feed.window = window
        observer = Observer(learner, mix["setup_tasks"], unit, window,
                            tuple(mix["trace_tasks"]) if run.traced else None)
        learner.train_evaluator = make_evaluator(learner, observer)
        end_epoch = learner._end_epoch

        def close_then_end(*a, **kw):
            setup.sync()
            window.close()
            run.facts["peak_bytes"] = setup.peak_bytes()
            return end_epoch(*a, **kw)

        learner._end_epoch = close_then_end
        hooks = [optim_hooks.register_optimizer_step_pre_hook(observer.pre_step),
                 optim_hooks.register_optimizer_step_post_hook(observer.post_step)]
        try:
            learner.train()
        finally:
            for h in hooks:
                h.remove()
        learner.logfile.close()
        step_s = learner.train_step_seconds[mix["setup_tasks"]:]
        steps = feed.handed - mix["setup_tasks"]
        if window.start is None or window.end is None or len(step_s) != steps:
            raise RuntimeError(f"window {window.start}-{window.end}: {len(step_s)} timed steps "
                               f"for {steps} tasks")
        run.facts.update(setup_s=window.start - run.started, window_s=window.seconds_measured,
                         tasks=steps, step_s=step_s)
        phase.seconds["the set-up's task steps and updates (the first builds or loads the "
                      "kernels)"] = round(window.start - phase.last, 3)
        phase.report()
        print(f"peak GiB where it grew, after task step: {observer.peaks}", flush=True)
        if observer.tracer is not None:
            run.trace = observer.tracer.summarise()
            first, count = mix["trace_tasks"]
            start = mix["setup_tasks"] + first
            run.trace.update(traced_work(cell, feed, range(start, start + count), settings))
        del learner
        gc.collect()
        setup.sync()
        t0 = time.perf_counter()
        run.numbers = check(run, feed, observer, settings)
        run.facts["check_s"] = time.perf_counter() - t0
    return steps


def traced_work(cell, feed, tasks, settings) -> dict:
    """The traced steps' summed kernel bounds, model FLOPs and kernel
    calls, from their shapes (``roofline.Work.lite_task``)."""
    def add(work):
        for j in tasks:
            shape = feed.shape(j)
            work.lite_task(sum(shape["context_clips"]), sum(shape["target_clips"]),
                           settings["batch_size"], settings["num_lite_samples"],
                           settings["learn_extractor"])
    return roofline.traced_work(cell.config, add)


def leaf_gaps(ours: Dict[str, float], ref: Dict[str, float], keep) -> Dict[str, float]:
    """Each leaf's |ours - ref| over the larger of the reference's value for
    that leaf and the median leaf's; a leaf missing from ``ours`` (no
    gradient reached the update) reads 0."""
    median = statistics.median(ref[k] for k in keep)
    return {k: abs(ours.get(k, 0.0) - ref[k]) / max(ref[k], median) for k in keep}


def episodes(run, feed) -> list:
    """The set-up's tasks, rebuilt from the seed and padded as the learner
    pads them."""
    tasks = [feed.make(j) for j in range(run.cell.mix["setup_tasks"])]
    return lite.episodes(tasks, roofline.SIZE_BUCKETS)


def reference_steps(run, feed, settings, tf32: bool = False, fault: Optional[str] = None):
    """(the reference's outputs of the set-up's steps, as ``gaps`` takes
    them, and the initial leaves)."""
    from port_bench.reference.precision import tf32 as precision

    model = setup.reference(run.cell.config, run.seed, run.device, feed.bank)
    p0 = {k: v.detach().clone() for k, v in model.extractor.named_parameters()}
    with precision(tf32):
        out = lite.steps(model, episodes(run, feed), run.seed, settings, run.device, fault)
    out["grad_norms"] = {k: float(v.norm()) for k, v in out.pop("grads").items()}
    return out, p0


def gaps(ours: dict, ref: dict, p0: dict, eps: list, settings: dict,
         facts=None) -> Dict[str, float]:
    """Each step's logits (worst relative gap) and loss (from its logits,
    its gap taken against the larger of that step's reference loss and the
    median step's: a task whose classes the random weights already part by
    wide margins reads a loss of exactly 0 in float64);
    at the first update the worst leaf's gradient norm, and after the
    set-up's updates the median leaf's change, each leaf's gap taken
    against the larger of the reference's norm for that leaf and the median
    leaf's. The change is read at the median leaf, not the worst: Adam's
    first steps move each element by about the rate whatever its
    gradient's size, so where ``g + decay * p`` is near 0 an element's
    direction follows rounding, and the worst of 150 leaves is a small one
    whose gap swings from seed to seed (PERF.md). Leaves whose
    reference gradient is under a thousandth of the median leaf's move by
    Adam's round-off alone and are left out of the change."""
    numbers = {"logits": 0.0, "loss": 0.0}
    losses = []
    for mine, theirs, ep in zip(ours["logits"], ref["logits"], eps):
        gap = np.abs(mine.astype(np.float64) - theirs).max() / np.abs(theirs).max()
        numbers["logits"] = max(numbers["logits"], float(gap))
        losses.append((lite.loss(mine, ep["target_labels"], ep["n_context"], settings),
                       lite.loss(theirs, ep["target_labels"], ep["n_context"], settings)))
    floor = statistics.median(abs(b) for _, b in losses)
    numbers["loss"] = max(abs(a - b) / max(abs(b), floor) for a, b in losses)
    grads = ref["grad_norms"]
    by_leaf = leaf_gaps(ours["grad_norms"], grads, grads)
    numbers["grad_norm"] = max(by_leaf.values())
    median = statistics.median(grads.values())
    moved = [k for k, v in grads.items() if v >= 1e-3 * median]
    mine = {k: float((ours["params"][k].to(p0[k].device) - p0[k]).norm()) for k in moved}
    theirs = {k: float((ref["params"][k].to(p0[k].device) - p0[k]).norm()) for k in moved}
    changes = leaf_gaps(mine, theirs, moved)
    numbers["update_norm"] = statistics.median(changes.values())
    if facts is not None:
        worst = max(changes, key=changes.get)
        facts["update_leaves"] = [len(moved), len(grads)]
        facts["worst_leaves"] = {"grad_norm": max(by_leaf, key=by_leaf.get),
                                 "update": [worst, changes[worst], int(p0[worst].numel())]}
    return numbers


def check(run, feed, observer, settings) -> Dict[str, float]:
    """The check's numbers: the set-up's steps against the reference."""
    ref, p0 = reference_steps(run, feed, settings)
    ours = {"logits": observer.logits, "grad_norms": observer.grad_norms,
            "params": observer.params}
    return gaps(ours, ref, p0, episodes(run, feed), settings, run.facts)


def readings(cell, args, device, out) -> None:
    """The check's readings (``port_bench/readings.py``): whole runs on the
    program's seeds; on the control's, the reference's steps against the
    reference in TF32 and with each planted fault."""
    for seed in args.seeds:
        t0 = time.perf_counter()
        run_ = core.Run(cell, seed, 1.0, False, time.perf_counter(), device=device)
        run(run_)
        out["program"][str(seed)] = run_.numbers
        print(f"program seed {seed}: {run_.numbers} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    for seed in args.control:
        run_ = core.Run(cell, seed, 1.0, False, time.perf_counter(), device=device)
        bank = FrameBank(cell.mix["frame_bank"], bank_objects(cell.mix), setup.bank_seed(seed),
                         device, cell.config["architecture"]["image_size"])
        feed = TrainFeed(cell.mix, bank, seed)
        with setup.Scratch() as scratch:
            settings = train_settings(cell.config, setup.learner_args(
                cell.config, "train", scratch, seed, cell.config["train_flags"]))
        t0 = time.perf_counter()
        ref, p0 = reference_steps(run_, feed, settings)
        print(f"reference seed {seed}: {time.perf_counter() - t0:.1f} s", flush=True)
        eps = episodes(run_, feed)
        for kind in ("control", *args.faults):
            t0 = time.perf_counter()
            ours, _ = (reference_steps(run_, feed, settings, tf32=True) if kind == "control"
                       else reference_steps(run_, feed, settings, fault=kind))
            numbers = gaps(ours, ref, p0, eps, settings)
            out.setdefault(kind, {})[str(seed)] = numbers
            print(f"{kind} seed {seed}: {numbers} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
