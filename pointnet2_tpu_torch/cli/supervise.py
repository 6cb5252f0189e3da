"""Supervised training: restart the training CLI when its watchdog fires.

Port of pointnet2_tpu/cli/supervise.py. The trainer's stall watchdog
(train/watchdog.py) exits with EXIT_STALLED (75) when no step or eval batch
completes for ``--watchdog_secs``; this supervisor then restarts the same
command after a backoff, and the trainer resumes exactly from its last
checkpoint (the epoch is in the checkpoint's sidecar). Any other exit code
(0, a traceback, a bad flag, out of memory) ends the supervision with that
code.

Usage (everything after the supervisor's own flags goes to
``pointnet2_tpu_torch.cli.train``; without ``--watchdog_secs`` there a
watchdog of DEFAULT_TIMEOUT_S is added, so that stalls become exits):

  python -m pointnet2_tpu_torch.cli.supervise --max_restarts 10 -- \\
      --model pointnet2_cls_ssg --data ... --log_dir runs/x
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

from pointnet2_tpu_torch.train.watchdog import DEFAULT_TIMEOUT_S, EXIT_STALLED


def supervise(cmd: list[str], max_restarts: int = 10,
              backoff_secs: float = 60.0, log_fn=print,
              _sleep=time.sleep) -> int:
    """Run cmd, restarting on EXIT_STALLED up to max_restarts times.
    Returns the final exit code (0 on success)."""
    attempt = 0
    while True:
        rc = subprocess.run(cmd).returncode
        if rc != EXIT_STALLED:
            if attempt:
                log_fn(f"supervise: finished with rc={rc} after "
                       f"{attempt} restart(s)")
            return rc
        attempt += 1
        if attempt > max_restarts:
            log_fn(f"supervise: stalled {attempt} times, giving up")
            return rc
        log_fn(f"supervise: stall #{attempt}; restarting in "
               f"{backoff_secs:.0f}s (resumes from the checkpoint)")
        _sleep(backoff_secs)


def train_command(train_args: list[str]) -> list[str]:
    """The cli.train command for ``train_args`` (a leading ``--`` dropped),
    with a watchdog of DEFAULT_TIMEOUT_S unless one is given."""
    if train_args and train_args[0] == "--":
        train_args = train_args[1:]
    if not any(a == "--watchdog_secs" or a.startswith("--watchdog_secs=")
               for a in train_args):
        train_args = [*train_args, "--watchdog_secs", str(DEFAULT_TIMEOUT_S)]
    return [sys.executable, "-m", "pointnet2_tpu_torch.cli.train",
            *train_args]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--max_restarts", type=int, default=10)
    ap.add_argument("--backoff_secs", type=float, default=60.0)
    ap.add_argument("train_args", nargs=argparse.REMAINDER,
                    help="arguments for pointnet2_tpu_torch.cli.train "
                         "(prefix with --)")
    args = ap.parse_args(argv)
    sys.exit(supervise(train_command(args.train_args), args.max_restarts,
                       args.backoff_secs))


if __name__ == "__main__":
    main()
