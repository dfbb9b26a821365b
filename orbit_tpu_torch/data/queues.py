"""Task queues: background-prefetched streams of episodic tasks.

Replaces the reference's torch DataLoader + worker processes
(data/queues.py:8-79) with a thread-pipelined sample->decode stream: task
*plans* are cheap (pure Python), so one producer thread plans and decodes
ahead (PIL releases the GIL) while the device computes.

Copy of ``orbit_tpu/data/queues.py`` for the PyTorch port, which imports
nothing of the JAX package; keep the two in step.
"""
from __future__ import annotations

import queue as _queue
import random
import threading
from typing import Dict, Iterator, List, Optional, Union

from orbit_tpu_torch.data.index import DatasetIndex, build_index
from orbit_tpu_torch.data.loader import FrameLoader
from orbit_tpu_torch.data.sampling import SamplingConfig, sample_task_plan, task_order


class DatasetQueue:
    """Queue of tasks sampled episodically from a DatasetIndex.

    ``get_tasks()`` yields ``task_dict``s in the same order contract as the
    reference (each user/object repeated num_tasks times; shuffled for train).
    """

    def __init__(
        self,
        root: str,
        way_method: str,
        object_cap: Union[int, str],
        shot_methods,
        shots,
        video_types,
        subsample_factor: int,
        clip_methods,
        clip_length: int,
        frame_size: int,
        frame_norm_method: str,
        annotations_to_load: Optional[List[str]] = None,
        filter_by_annotations=(None, None),
        num_tasks: int = 50,
        test_mode: bool = False,
        with_cluster_labels: bool = False,
        with_caps: bool = False,
        shuffle: bool = False,
        num_threads: int = 4,
        prefetch: int = 2,
        seed: Optional[int] = None,
        logfile=None,
        object_centric: bool = False,
        cluster_label_dir: str = "data",
        num_shards: int = 1,
        shard_index: int = 0,
        raw_uint8: bool = False,
    ):
        self.index: DatasetIndex = build_index(
            root,
            context_type=video_types[0],
            target_type=video_types[1],
            frame_size=frame_size,
            annotations_to_load=annotations_to_load,
            filter_context=filter_by_annotations[0],
            filter_target=filter_by_annotations[1],
            with_cluster_labels=with_cluster_labels,
            cluster_label_dir=cluster_label_dir,
            logfile=logfile,
        )
        self.cfg = SamplingConfig(
            way_method=way_method,
            object_cap=object_cap,
            shot_method_context=shot_methods[0],
            shot_method_target=shot_methods[1],
            shot_context=shots[0],
            shot_target=shots[1],
            clip_method_context=clip_methods[0],
            clip_method_target=clip_methods[1],
            clip_length=clip_length,
            subsample_factor=subsample_factor,
            with_caps=with_caps,
            test_mode=test_mode,
            frame_size=frame_size,
        )
        self.loader = FrameLoader(frame_size, frame_norm_method, num_threads=num_threads,
                                  frame2anns=self.index.frame2anns,
                                  annotations_to_load=annotations_to_load,
                                  raw_uint8=raw_uint8)
        self.num_tasks = num_tasks
        self.shuffle = shuffle
        self.prefetch = prefetch
        self.with_cluster_labels = with_cluster_labels
        self.object_centric = object_centric
        # host-parallel loading (SURVEY.md §2.9 item 3): in a multi-host
        # deployment each host feeds its own strided slice of the task
        # stream. All randomness is keyed, not streamed: the task ORDER
        # comes from a rng seeded per (seed, epoch), and each task's PLAN
        # from a rng seeded per (seed, epoch, item, occurrence) — see
        # get_tasks. A single shared stream would consume a data-dependent
        # number of draws per host, desynchronising multi-host shuffles
        # after epoch 1 (advisor finding, round 2) and making a shard's
        # tasks differ from the same user's tasks in a single-host run.
        # Keyed seeding makes the k-th task of user u a pure function of
        # the run config — so merged sharded results reproduce the
        # single-host run exactly, per user.
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.seed = seed
        self._epoch = 0

    # --- sizing -----------------------------------------------------------
    @property
    def num_users(self) -> int:
        return self.index.num_users

    def __len__(self) -> int:
        return self.index.num_objects if self.object_centric else self.index.num_users

    def get_num_users(self) -> int:
        return self.num_users

    def get_cluster_classes(self):
        return self.index.cluster_classes

    def num_local_tasks(self) -> int:
        """Tasks THIS shard will yield (whole-user blocks of ``num_tasks``);
        equals the global total on a single host. Drivers must use this —
        not ``num_users * num_tasks`` — for end-of-stream boundaries."""
        n_blocks = len(self)
        if self.num_shards > 1:
            n_blocks = len(range(self.shard_index, n_blocks, self.num_shards))
        return n_blocks * self.num_tasks

    # --- task stream ------------------------------------------------------
    def _plan(self, item: int, rng: random.Random):
        if self.object_centric:
            # object-centric: the task draws from ALL objects in the split
            task_objects = list(range(self.index.num_objects))
            task_id = self.index.obj2name[item]
        else:
            user = self.index.users[item]
            task_objects = self.index.user2objs[user]
            task_id = user
        obj2cluster = self.index.obj2cluster if self.with_cluster_labels else None
        return sample_task_plan(self.index, task_objects, task_id, self.cfg, rng, obj2cluster)

    def _plan_rng(self, epoch: int, item: int, occurrence: int) -> random.Random:
        """The k-th task of item (user/object) in an epoch is a pure function
        of (seed, epoch, item, k): identical across hosts, shard layouts and
        stream positions, so sharded runs reproduce single-host results."""
        return random.Random(f"plan:{self.seed}:{epoch}:{item}:{occurrence}")

    def get_tasks(self) -> Iterator[Dict]:
        # ordering is keyed on (seed, epoch) only: every host derives the
        # IDENTICAL shuffled order each epoch, keeping the block partition
        # below disjoint regardless of what each host consumed before
        epoch = self._epoch
        self._epoch += 1
        order_rng = random.Random(f"order:{self.seed}:{epoch}")
        order = task_order(order_rng, len(self), self.num_tasks, self.shuffle)
        # annotate each position with its GLOBAL occurrence count k (the
        # k-th appearance of that item in this epoch's order) BEFORE
        # sharding: a shuffled train order scatters one user across shards,
        # and shard-local counting would hand two hosts the same (item, k)
        # plan — the same episode trained twice
        counts: Dict[int, int] = {}
        annotated = []
        for item in order:
            k = counts.get(item, 0)
            counts[item] = k + 1
            annotated.append((item, k))
        if self.num_shards > 1:
            # shard at whole-user/object granularity (blocks of num_tasks):
            # each host owns complete per-user task groups, so downstream
            # per-user aggregation (evaluators, challenge results.json)
            # stays correct on every shard. Shuffled train orders are
            # partitioned the same way — any deterministic disjoint
            # partition is valid there.
            blocks = [annotated[i:i + self.num_tasks]
                      for i in range(0, len(annotated), self.num_tasks)]
            annotated = [t for b in blocks[self.shard_index::self.num_shards]
                         for t in b]

        def load(item: int, k: int):
            return self.loader.load_task(
                self._plan(item, self._plan_rng(epoch, item, k)))

        if self.prefetch <= 0:
            for item, k in annotated:
                yield load(item, k)
            return

        # Two-stage producer pipeline ahead of the consumer:
        #   plan thread  -> decode thread -> consumer (device compute)
        # Task PLANS are pure Python (GIL-bound, measured ~50 ms/plan at
        # benchmark scale — PERF.md); frame DECODE spends its time in
        # GIL-releasing PIL/JPEG C code. Splitting them lets plan(t+1) run
        # during decode(t)'s C-land time instead of serialising both in one
        # thread (VERDICT r4 item 3). Plans are keyed functions of
        # (seed, epoch, item, k), so planning ahead cannot reorder anything.
        # If the consumer abandons the generator (step-loop exception,
        # partial iteration), the finally below stops both threads and
        # drains both queues — otherwise a thread blocks on a full queue
        # forever, pinning decoded task_dicts (same fix as
        # data/episodes.py prefetch_prepared).
        out: _queue.Queue = _queue.Queue(maxsize=self.prefetch)
        plans: _queue.Queue = _queue.Queue(maxsize=max(2, self.prefetch))
        stop = threading.Event()
        _SENTINEL = object()

        def put(q, item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def get(q):
            # stop-aware, like put(): an abandoning consumer drains the
            # queues BEFORE the plan stage's sentinel lands, so a bare
            # blocking get here would strand this thread forever (round-5
            # review finding)
            while not stop.is_set():
                try:
                    return q.get(timeout=0.1)
                except _queue.Empty:
                    continue
            return _SENTINEL

        def plan_stage():
            try:
                for item, k in annotated:
                    if stop.is_set():
                        return
                    plan = self._plan(item, self._plan_rng(epoch, item, k))
                    if not put(plans, plan):
                        return
            except BaseException as e:  # surfaced through the decode stage
                put(plans, e)
            finally:
                put(plans, _SENTINEL)

        def decode_stage():
            try:
                while not stop.is_set():
                    got = get(plans)
                    if got is _SENTINEL:
                        return
                    if isinstance(got, BaseException):
                        put(out, got)
                        return
                    if not put(out, self.loader.load_task(got)):
                        return
            except BaseException as e:  # surfaced on the consumer side
                put(out, e)
            finally:
                put(out, _SENTINEL)

        threads = [threading.Thread(target=plan_stage, daemon=True,
                                    name="orbit-plan-stage"),
                   threading.Thread(target=decode_stage, daemon=True,
                                    name="orbit-decode-stage")]
        for t in threads:
            t.start()
        try:
            while True:
                got = out.get()
                if got is _SENTINEL:
                    break
                if isinstance(got, BaseException):
                    raise got
                yield got
        finally:
            stop.set()
            for q in (plans, out):
                try:  # unblock pending producer puts; drop their payloads
                    while True:
                        q.get_nowait()
                except _queue.Empty:
                    pass


class UserEpisodicDatasetQueue(DatasetQueue):
    """User-centric episodes: one task == one user's objects
    (reference: data/queues.py:42-59)."""

    def __init__(self, *args, **kwargs):
        kwargs["object_centric"] = False
        super().__init__(*args, **kwargs)


class ObjectEpisodicDatasetQueue(DatasetQueue):
    """Object-centric episodes: tasks draw from all objects in the split
    (reference: data/queues.py:61-79)."""

    def __init__(self, *args, **kwargs):
        kwargs["object_centric"] = True
        super().__init__(*args, **kwargs)
