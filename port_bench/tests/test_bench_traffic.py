"""The traffic mixes: their stored task shapes are the sampling rules
applied to the split files, at the test split's real task sizes; the feed
makes the same tasks for one seed and distinct rows within a task."""
from __future__ import annotations

import json

import numpy as np
import pytest

from conftest import DATA, ROOT

MIXES = ["clu_ve", "lite_train"]


def mix(name):
    return json.loads((ROOT / "port_bench" / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_stored_tasks_are_the_derivation(name):
    from port_bench.traffic import sampling

    m = mix(name)
    assert m["tasks"] == sampling.derive(m, ROOT)
    assert m["realised"] == sampling.summary(m["tasks"])


def test_clu_ve_sizes():
    m = mix("clu_ve")
    r = m["realised"]
    assert r["tasks"] == len(m["users"]) == 17
    assert r["way"][:2] == [5, 13]
    assert r["context_rows"][:2] == [528, 1776] and r["target_rows"][:2] == [1400, 17600]
    assert m["window_unit_tasks"] == 17


def test_lite_train_means():
    m = mix("lite_train")
    r = m["realised"]
    assert len(m["users"]) == 44 and r["tasks"] == 4 * 44
    assert 300 <= r["context_rows"][2] <= 400 and 500 <= r["target_rows"][2] <= 600
    assert m["setup_tasks"] % 16 == 0 and m["window_unit_tasks"] == 16


def test_uniform_clips_of_a_700_frame_video():
    from port_bench.traffic import sampling

    assert sampling.uniform_clips(700, 30) == 24


@pytest.mark.parametrize("name", ["clu_ve_tiny", "lite_train_tiny"])
def test_feed_is_seeded(name):
    from port_bench import core
    from port_bench.traffic.feed import FrameBank, bank_objects

    m = json.loads((DATA / f"{name}.json").read_text())
    feed = core.loop(m["loop"]).Feed
    bank = FrameBank(m["frame_bank"], bank_objects(m), 5, "cpu", 32)
    again = FrameBank(m["frame_bank"], bank_objects(m), 5, "cpu", 32)
    assert np.array_equal(bank.frames, again.frames)
    a, b = feed(m, bank, 9), feed(m, bank, 9)
    for j in range(3):
        ta, tb = a.make(j), b.make(j)
        assert np.array_equal(ta["context_clips"], tb["context_clips"])
        rows = ta["context_clips"].reshape(len(ta["context_clips"]), -1)
        assert len(np.unique(rows, axis=0)) == len(rows)
    other = feed(m, bank, 10).make(0)
    assert not np.array_equal(other["context_clips"], a.make(0)["context_clips"])


def test_bank_rows_past_its_end_differ():
    from port_bench.traffic.feed import FrameBank

    bank = FrameBank({"frames_per_object": 4, "colour": [60, 60], "noise": 20}, 1, 1, "cpu", 8)
    rows = bank.rows(0, 2, 10)
    assert len(np.unique(rows.reshape(10, -1), axis=0)) == 10


def test_window_holds_whole_units():
    from port_bench.traffic.feed import Window

    w = Window(0.0, 3, before=2)
    assert not w.done(5)
    w.open()
    assert [w.done(h) for h in range(2, 9)] == [False, False, False, True, False, False, True]

