"""The one traffic generator: seeded, and the same work for every seed."""

import numpy as np

from portbench import core, streams
from portbench.tests.tiny import BENCH_DIR

TRAFFIC = core.read_json(f"{BENCH_DIR}/traffic/batch32.json")
SMALL = dict(TRAFFIC, copies=2,
             events={"min": 1000, "max": 5000, "levels": 6})


def test_same_seed_same_streams_other_seed_other_streams():
    a = streams.stream_pool(SMALL, (180, 240), 2 ** 33 + 5)
    b = streams.stream_pool(SMALL, (180, 240), 2 ** 33 + 5)
    c = streams.stream_pool(SMALL, (180, 240), 2 ** 33 + 6)
    for la, lb, lc in zip(a, b, c):
        for x, y, z in zip(la, lb, lc):
            np.testing.assert_array_equal(x, y)
            assert x.shape == z.shape and not np.array_equal(x, z)


def test_every_seed_gets_the_same_lengths():
    n = streams.lengths(TRAFFIC["events"])
    assert len(n) == 32 and min(n) > 100000 and max(n) < 225000
    for seed in (1, 2 ** 31 + 11):
        pool = streams.stream_pool(SMALL, (180, 240), seed)
        assert [len(p[0]) for p in pool] == streams.lengths(SMALL["events"])


def test_streams_are_sensor_events():
    s = streams.stream_pool(SMALL, (180, 240), 3)[0][0]
    assert s.dtype == np.float32 and s.shape[1] == 4
    assert (s[:, 0] >= 0).all() and (s[:, 0] < 240).all()
    assert (s[:, 1] >= 0).all() and (s[:, 1] < 180).all()
    np.testing.assert_array_equal(s[:, :2], np.floor(s[:, :2]))
    assert set(np.unique(s[:, 3])) == {-1.0, 1.0}
    assert (np.diff(s[:, 2]) >= 0).all()


def test_each_request_takes_one_stream_of_every_level():
    sched = streams.request_schedule(SMALL, 9)
    reqs = [next(sched) for _ in range(20)]
    for r in reqs:
        assert sorted(lvl for lvl, _ in r) == list(range(6))
        assert all(0 <= c < 2 for _, c in r)
    again = streams.request_schedule(SMALL, 9)
    assert [next(again) for _ in range(20)] == reqs
    other = streams.request_schedule(SMALL, 10)
    assert [next(other) for _ in range(20)] != reqs
