"""Rate and latency arithmetic on synthetic stamps, histogram deltas,
and the comparison failing on one changed, dropped or
doubled MatchOut record."""

import numpy as np
import pytest

from kmebench import measure as M
from kmebench.consumer import is_close


def test_close_times_follow_the_closing_records():
    # fetch 1 brings 3 records at t=1.0, fetch 2 brings 4 at t=2.0
    closes = np.array([0, 1, 0, 0, 0, 1, 1], np.uint8)
    done = M.close_times(closes, [1.0, 2.0], [3, 4])
    assert list(done) == [1.0, 2.0, 2.0]


def test_rate_counts_messages_closed_inside_the_window():
    done = np.array([0.5, 1.0, 1.5, 2.9, 3.0, 3.5])
    assert M.completed_in(done, 1.0, 3.0) == 3     # [1.0, 3.0)


def test_latency_from_due_time_and_unanswered_messages():
    done = np.array([9.0, 10.1, 10.3])             # message 0 is warm-up
    due = np.array([10.0, 10.2, 10.4])             # messages 1..3
    lat = M.latencies(done, 1, due, unanswered_at=20.0)
    assert np.allclose(lat, [0.1, 0.1, 9.6])      # 3 never answered
    assert M.percentile(lat, 50) == pytest.approx(0.1)
    assert M.percentile(lat, 99) > 9.0
    assert M.percentile(np.array([]), 99) is None
    # two of the three within 100 ms; the unanswered one is not
    assert M.share_within(lat, 0.1 + 1e-9) == pytest.approx(2 / 3)


def test_histogram_quantile_of_a_window_delta():
    bounds = (1e-3, 2e-3, 4e-3)
    m0 = {"latencies": {"lat_x": {"buckets": [5, 0, 0, 0]}}}
    m1 = {"latencies": {"lat_x": {"buckets": [5, 50, 50, 0]}}}
    d = M.latency_delta(m0, m1, "lat_x")
    assert d == [0, 50, 50, 0]
    assert M.hist_quantile(d, bounds, 0.5) == pytest.approx(2e-3)
    assert M.hist_quantile(d, bounds, 0.99) == pytest.approx(3.96e-3)
    assert M.hist_quantile([0, 0, 0, 0], bounds, 0.99) is None
    assert M.latency_delta(m0, None, "lat_x") is None
    assert M.gauge_delta({"gauges": {"plan_s": 1.0}},
                         {"gauges": {"plan_s": 3.5}}, "plan_s") == 2.5


REF = [b'IN {"action":2,"oid":1,"aid":0,"sid":0,"price":50,"size":5,'
       b'"next":null,"prev":null}',
       b'OUT {"action":2,"oid":1,"aid":0,"sid":0,"price":50,"size":5,'
       b'"next":null,"prev":null}',
       b'IN {"action":3,"oid":2,"aid":1,"sid":0,"price":50,"size":5,'
       b'"next":null,"prev":null}',
       b'OUT {"action":6,"oid":1,"aid":0,"sid":0,"price":0,"size":5,'
       b'"next":null,"prev":null}',
       b'OUT {"action":5,"oid":2,"aid":1,"sid":0,"price":0,"size":5,'
       b'"next":null,"prev":null}',
       b'OUT {"action":3,"oid":2,"aid":1,"sid":0,"price":50,"size":0,'
       b'"next":null,"prev":null}']
COUNTS = np.array([2, 4])


def test_the_same_records_compare_equal():
    w = M.digests(REF)
    assert M.records_differing(w, w) == 0
    assert M.first_difference(w, w) is None
    assert M.messages_wrong(w, w, COUNTS) == 0


@pytest.mark.parametrize("fault", ["changed", "dropped", "doubled"])
def test_one_bad_record_fails_the_comparison(fault):
    got = list(REF)
    if fault == "changed":
        got[3] = got[3].replace(b'"size":5', b'"size":4')
    elif fault == "dropped":
        del got[3]
    else:
        got.insert(3, got[3])
    g, w = M.digests(got), M.digests(REF)
    assert M.records_differing(g, w) >= 1
    # a doubled record shows where the next one was due
    assert M.first_difference(g, w) == (4 if fault == "doubled" else 3)
    assert M.messages_wrong(g, w, COUNTS) == 1


def test_doubled_exactly_once_stamps_are_counted():
    assert M.records_doubled(np.array([0, 1, 2, 3])) == 0
    assert M.records_doubled(np.array([0, 1, 1, 2, -1, -1])) == 1


def test_a_message_closes_on_its_result_echo():
    keys = [r.split(b" ", 1) for r in REF]
    flags = [is_close(k.decode(), v.decode()) for k, v in keys]
    assert flags == [False, True, False, False, False, True]
