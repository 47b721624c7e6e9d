"""Job launchers with log capture: local array jobs + pluggable batch
submission.

The port's own copy of ``convtasnet_tpu/utils/jobs.py`` (the stdlib only,
the same names).

Capability parity with the vendored Kaldi job tools:

- ``run_jobs`` = ``run.pl`` (``egs/wsj0/utils/run.pl``): run ``JOB=1:N``
  array jobs as local processes, capture each job's stdout/stderr to
  ``<log>``-style files, propagate failures, report how many failed.
- ``submit`` / ``submit_jobs`` = the ``queue.pl`` capability
  (``egs/wsj0/utils/queue.pl:1-624``): hand a command to a batch scheduler
  via a ``--cmd``-style template instead of 624 lines of GridEngine
  plumbing. The template is a format string with ``{script}`` and ``{log}``
  placeholders and must BLOCK until the job completes, e.g.::

      "sbatch --wait -o {log} {script}"        # Slurm
      "qsub -sync y -j y -o {log} {script}"    # SGE
      "bash {script} > {log} 2>&1"             # degenerate local template

  (These launchers cover recipe-stage *scheduling* only, like the
  originals, not communication between processes.)
"""

from __future__ import annotations

import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional


class JobError(RuntimeError):
    pass


def run_jobs(
    command: str,
    n_jobs: int = 1,
    log: str = "run.JOB.log",
    job_name: str = "JOB",
    max_parallel: Optional[int] = None,
    env: Optional[dict] = None,
) -> List[int]:
    """Run ``command`` for JOB = 1..n_jobs, substituting ``job_name``.

    Args:
        command: shell command; occurrences of ``job_name`` are replaced with
            the 1-based job index (run.pl's JOB=1:N convention).
        log: log path template, ``job_name`` substituted per job.
        max_parallel: concurrent jobs (default: all).

    Returns:
        list of exit codes (all zero on success).

    Raises:
        JobError if any job fails, naming the failing logs (run.pl's
        "failed, log is in ..." behavior).
    """

    def run_one(job: int) -> int:
        cmd = command.replace(job_name, str(job))
        log_path = log.replace(job_name, str(job))
        os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
        with open(log_path, "w") as f:
            f.write(f"# {cmd}\n# Started {__import__('time').ctime()}\n")
            f.flush()
            proc = subprocess.run(
                cmd, shell=True, stdout=f, stderr=subprocess.STDOUT,
                env={**os.environ, **(env or {})})
            f.write(f"# Exit code {proc.returncode}\n")
        return proc.returncode

    workers = max_parallel or n_jobs
    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        codes = list(pool.map(run_one, range(1, n_jobs + 1)))
    failed = [j + 1 for j, c in enumerate(codes) if c != 0]
    if failed:
        logs = ", ".join(log.replace(job_name, str(j)) for j in failed[:3])
        raise JobError(
            f"{len(failed)}/{n_jobs} jobs failed; see logs: {logs}")
    return codes


def submit(
    command: str,
    log: str,
    cmd_template: str = "local",
    env: Optional[dict] = None,
) -> int:
    """Run one command under a submission template (queue.pl capability).

    ``cmd_template="local"`` executes in-process with log capture (run.pl
    behavior for a single job). Otherwise the command is written to
    ``<log>.sh`` and the rendered template — which must block until the job
    finishes — is executed; its exit code is the job's.

    Raises JobError on nonzero exit, naming the log.
    """
    if cmd_template in ("", "local", "run.pl"):
        codes = run_jobs(command, n_jobs=1, log=log, env=env)
        return codes[0]
    os.makedirs(os.path.dirname(os.path.abspath(log)) or ".", exist_ok=True)
    script = log + ".sh"
    with open(script, "w") as f:
        f.write("#!/usr/bin/env bash\nset -e\n" + command + "\n")
    os.chmod(script, 0o755)
    rendered = cmd_template.format(script=script, log=log)
    proc = subprocess.run(
        rendered, shell=True, env={**os.environ, **(env or {})})
    if proc.returncode != 0:
        raise JobError(
            f"submitted job failed (rc={proc.returncode}); log: {log}")
    return proc.returncode


def submit_jobs(
    command: str,
    n_jobs: int,
    log: str,
    cmd_template: str = "local",
    job_name: str = "JOB",
    max_parallel: Optional[int] = None,
    env: Optional[dict] = None,
) -> List[int]:
    """JOB=1:N array submission through ``cmd_template`` (queue.pl's array
    mode). Local template delegates to run_jobs; scheduler templates submit
    each job and wait (template must block)."""
    if cmd_template in ("", "local", "run.pl"):
        return run_jobs(command, n_jobs=n_jobs, log=log, job_name=job_name,
                        max_parallel=max_parallel, env=env)
    codes = []
    failures = []
    workers = max(1, max_parallel or n_jobs)

    def one(job: int) -> int:
        return submit(command.replace(job_name, str(job)),
                      log.replace(job_name, str(job)),
                      cmd_template=cmd_template, env=env)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        futs = {j: pool.submit(one, j) for j in range(1, n_jobs + 1)}
        for j, fut in futs.items():
            try:
                codes.append(fut.result())
            except JobError:
                failures.append(j)
                codes.append(1)
    if failures:
        logs = ", ".join(
            log.replace(job_name, str(j)) for j in failures[:3])
        raise JobError(
            f"{len(failures)}/{n_jobs} submitted jobs failed; logs: {logs}")
    return codes
