"""`chip_smoke.py`'s scheduling of the CPU references (`_References`): the
2-layer DiT cases of phases 3e-3i and 12c run their card side when started
and their verdict (the CPU's fp32 reference and the comparison) on a worker
thread of their own, beside the later phases.  The smoke itself runs only
on the card; these check its scheduler and `_watch_tiny_seq`'s exclusion of
that thread on the CPU, with stand-in cases."""

import importlib.util
import pathlib
import threading
import time

import torch

from bindyouravatar_tpu_torch.ops import packed_attention as tpa

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _case(log, i, seconds=0.05, ok=True):
    def start():
        log.append(("start", i, threading.current_thread().name))

        def verdict():
            time.sleep(seconds)
            log.append(("verdict", i, threading.current_thread().name))
            return ok
        return verdict
    return start


def test_references_start_in_the_caller_and_judge_in_order_on_one_worker():
    smoke, log = _smoke(), []
    refs = smoke._References(ahead=2)
    for i in range(5):
        refs.add(_case(log, i))
    refs.add(lambda: None)                   # a case with no verdict
    refs.pump()
    # two unfinished verdicts at most: the pump started two cases
    assert [e[:2] for e in log] == [("start", 0), ("start", 1)]
    assert refs.drain()
    starts = [e for e in log if e[0] == "start"]
    verdicts = [e for e in log if e[0] == "verdict"]
    assert [e[1] for e in starts] == [0, 1, 2, 3, 4]
    assert [e[1] for e in verdicts] == [0, 1, 2, 3, 4]
    main = threading.current_thread().name
    assert all(e[2] == main for e in starts)
    assert len({e[2] for e in verdicts}) == 1 and verdicts[0][2] != main
    # no case started before the verdict two places ahead of it had ended
    order = [e[:2] for e in log]
    for i in range(2, 5):
        assert order.index(("verdict", i - 2)) < order.index(("start", i))


def test_references_drain_reports_a_failed_verdict_and_quiet_waits():
    smoke, log = _smoke(), []
    refs = smoke._References(ahead=3)
    refs.add(_case(log, 0, seconds=0.2))
    refs.add(_case(log, 1, ok=False))
    refs.add(_case(log, 2))
    refs.pump()
    refs.quiet()
    assert [e[1] for e in log if e[0] == "verdict"] == [0, 1, 2]
    assert refs.drain() is False


def test_watch_tiny_seq_counts_every_thread_but_the_reference_worker():
    """A server's worker or autograd's device thread runs the card's calls:
    counted; the `_References` worker's CPU references: not counted."""
    smoke = _smoke()
    q, k, v = (torch.randn(2, 5, 64) for _ in range(3))
    call = lambda: tpa.tiny_seq_attention_plain(q, k, v, 1, 0.125)
    with smoke._watch_tiny_seq() as seen:
        call()
        other = threading.Thread(target=call)
        other.start()
        other.join(timeout=60)
        assert not other.is_alive() and seen["plain"] == 2
        refs = smoke._References()
        refs.add(lambda: lambda: call() is not None)
        refs.pump()
        assert refs.drain()
        assert seen["plain"] == 2
    assert tpa.tiny_seq_attention_plain.__name__ == "tiny_seq_attention_plain"
