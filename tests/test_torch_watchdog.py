"""The stall watchdog, its wiring in Trainer.fit, and cli.supervise, on the
CPU.

Ports of tests/test_watchdog.py's in-process cases: the watchdog fires on a
stall (a stub in place of ``os._exit``), stays quiet while it is beaten, is
beaten by ``Trainer.fit`` after every call of the step and every eval
batch, and is closed when ``fit`` raises; ``supervise`` restarts its
command on exit 75 only and gives up after ``max_restarts``. The
supervised commands are ``sys.executable -c`` children that import
nothing of the port; no child process waits on a clock.
"""

import sys
import time

import pytest

from pointnet2_tpu_torch.cli import supervise as sup
from pointnet2_tpu_torch.data import SyntheticClassification
from pointnet2_tpu_torch.train import TrainConfig, Trainer
from pointnet2_tpu_torch.train import trainer as trainer_mod
from pointnet2_tpu_torch.train.watchdog import (
    DEFAULT_TIMEOUT_S,
    EXIT_STALLED,
    Watchdog,
)
from tests.test_torch_multi_step import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def test_watchdog_fires_on_a_stall():
    exits, logs = [], []
    wd = Watchdog(timeout_s=0.2, log_fn=logs.append, _exit_fn=exits.append)
    deadline = time.monotonic() + 10
    while not exits and time.monotonic() < deadline:
        time.sleep(0.05)
    wd.close()
    assert exits == [EXIT_STALLED] == [75]
    assert "WATCHDOG" in logs[0] and "75" in logs[0]


def test_watchdog_is_quiet_while_beaten_and_after_close():
    exits = []
    wd = Watchdog(timeout_s=1.0, log_fn=lambda s: None,
                  _exit_fn=exits.append)
    end = time.monotonic() + 2.5  # two polls of 1 s
    while time.monotonic() < end:
        wd.beat()
        time.sleep(0.05)
    wd.close()
    time.sleep(1.2)  # past the timeout, closed
    assert exits == []
    assert DEFAULT_TIMEOUT_S == 900.0


def test_watchdog_close_ends_its_thread():
    """close() returns after the thread has ended, not at its next poll
    (10 s at the default timeout): a watchdog thread still waiting at the
    interpreter's exit aborted cli.train with 134 after it had written its
    checkpoint (steps_per_call=2 on the CPU)."""
    wd = Watchdog(timeout_s=DEFAULT_TIMEOUT_S, log_fn=lambda s: None,
                  _exit_fn=lambda rc: None)
    t0 = time.monotonic()
    wd.close()
    assert not wd._thread.is_alive()
    assert time.monotonic() - t0 < 5.0


class _Recorder:
    """Watchdog stand-in: records its timeout, beats and close."""

    made: list = []

    def __init__(self, timeout_s, log_fn=print):
        self.timeout_s, self.beats, self.closed = timeout_s, 0, False
        _Recorder.made.append(self)

    def beat(self):
        self.beats += 1

    def close(self):
        self.closed = True


def _data():
    """3 train batches (the last padded) and 1 eval batch."""
    return (SyntheticClassification(num_classes=3, samples_per_class=3,
                                    npoints=32, batch_size=4, seed=0),
            SyntheticClassification(num_classes=3, samples_per_class=1,
                                    npoints=32, batch_size=4, seed=1))


@pytest.mark.parametrize("K", [1, 2])
def test_fit_beats_the_watchdog_and_closes_it(tmp_path, monkeypatch, K):
    """As JAX's loop beats: once a K batches trained and once after the
    epoch's last batches (K=1 over 3 batches: 3 + 1; K=2: a K-step call,
    then the remainder's single step, 1 + 1), once an eval batch; then
    closed."""
    monkeypatch.setattr(trainer_mod, "Watchdog", _Recorder)
    _Recorder.made = []
    train, evals = _data()
    cfg = TrainConfig(batch_size=4, num_point=32, max_epoch=1,
                      steps_per_call=K, watchdog_secs=123.0,
                      log_dir=str(tmp_path))
    with Trainer(cfg, device="cpu") as tr:
        tr.fit(train, eval_dataset=evals)
        assert tr._watchdog is None
    (wd,) = _Recorder.made
    calls = {1: 4, 2: 2}[K]
    assert wd.timeout_s == 123.0 and wd.closed
    assert wd.beats == calls + evals.num_batches()


def test_fit_closes_the_watchdog_when_it_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(trainer_mod, "Watchdog", _Recorder)
    _Recorder.made = []
    train, _ = _data()

    def broken(augment=False):
        yield next(iter(SyntheticClassification.epoch(train)))
        raise OSError("disk gone")

    train.epoch = broken
    cfg = TrainConfig(batch_size=4, num_point=32, watchdog_secs=5.0,
                      log_dir=str(tmp_path))
    with Trainer(cfg, device="cpu") as tr:
        with pytest.raises(OSError, match="disk gone"):
            tr.fit(train, max_epoch=1)
        assert tr._watchdog is None
    (wd,) = _Recorder.made
    assert wd.closed


def test_no_watchdog_without_watchdog_secs(tmp_path, monkeypatch):
    monkeypatch.setattr(trainer_mod, "Watchdog", _Recorder)
    _Recorder.made = []
    train, _ = _data()
    with Trainer(TrainConfig(batch_size=4, num_point=32,
                             log_dir=str(tmp_path)), device="cpu") as tr:
        tr.fit(train, max_epoch=1)
    assert _Recorder.made == []


def _child(code: str) -> list[str]:
    return [sys.executable, "-c", code]


def test_supervise_restarts_on_75_until_success(tmp_path):
    """A command that stalls twice, then succeeds: restarted twice, rc 0,
    each restart after the backoff."""
    count = tmp_path / "runs"
    count.write_text("0")
    code = (f"import sys; p = {str(count)!r}; n = int(open(p).read()) + 1; "
            f"open(p, 'w').write(str(n)); sys.exit(75 if n < 3 else 0)")
    sleeps, logs = [], []
    rc = sup.supervise(_child(code), max_restarts=5, backoff_secs=7.0,
                       log_fn=logs.append, _sleep=sleeps.append)
    assert rc == 0 and count.read_text() == "3"
    assert sleeps == [7.0, 7.0]
    assert "after 2 restart(s)" in logs[-1]


def test_supervise_gives_up_after_max_restarts():
    sleeps = []
    rc = sup.supervise(_child("import sys; sys.exit(75)"), max_restarts=2,
                       backoff_secs=0.0, log_fn=lambda s: None,
                       _sleep=sleeps.append)
    assert rc == EXIT_STALLED and len(sleeps) == 2


@pytest.mark.parametrize("rc", [0, 1, 3])
def test_supervise_does_not_restart_other_exits(rc):
    sleeps = []
    got = sup.supervise(_child(f"import sys; sys.exit({rc})"),
                        max_restarts=5, log_fn=lambda s: None,
                        _sleep=sleeps.append)
    assert got == rc and sleeps == []


def test_supervise_command_adds_a_watchdog():
    cmd = sup.train_command(["--", "--model", "pointnet2_cls_ssg"])
    assert cmd[:3] == [sys.executable, "-m", "pointnet2_tpu_torch.cli.train"]
    assert cmd[3:] == ["--model", "pointnet2_cls_ssg", "--watchdog_secs",
                       str(DEFAULT_TIMEOUT_S)]
    for given in (["--watchdog_secs", "60"], ["--watchdog_secs=60"]):
        assert sup.train_command(given)[3:] == given


def test_supervise_main_exits_with_the_commands_code(monkeypatch):
    seen = []
    monkeypatch.setattr(sup, "supervise",
                        lambda cmd, n, b: seen.append((cmd, n, b)) or 3)
    with pytest.raises(SystemExit) as e:
        sup.main(["--max_restarts", "4", "--backoff_secs", "1", "--",
                  "--synthetic"])
    assert e.value.code == 3
    (cmd, n, b), = seen
    assert (n, b) == (4, 1.0) and cmd[3] == "--synthetic"
