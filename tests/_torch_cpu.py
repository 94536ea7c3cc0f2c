"""The one CPU-thread policy of the port's tests.

Every ``tests/test_torch_*.py`` imports :func:`one_thread`, a module-scoped
autouse fixture, so that its tests run at one torch intra-op thread; it
hands :func:`env` to every process it starts, and a rank it spawns calls
:func:`start_rank` first. One thread, for two reasons:

* the CPU's sums split by thread count, so a result made in the test's own
  process and one made in a rank or a subprocess agree bit for bit only at
  one count, the same in both;
* the port's CPU twins are thousands of tiny ops, which crawl on many
  threads while the suite's other workers hold the cores (six workers at
  eight threads each on eight cores ran a file 13 to 42 times slower than
  the same file alone).

``tests/test_torch_suite.py`` fails if a port test module lacks the import
or sets the thread count itself. Imported as a top-level module (pytest puts
``tests/`` on the path).
"""

from __future__ import annotations

import os

import pytest
import torch

THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's tests at :data:`THREADS` intra-op threads; the count
    before is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(threads)


def env(**extra: str) -> dict[str, str]:
    """The environment of a process a port test starts: this one's, at
    :data:`THREADS` OpenMP threads (torch's intra-op count in that process),
    with ``extra`` on top."""
    return {**os.environ, "OMP_NUM_THREADS": str(THREADS), **extra}


def start_rank() -> None:
    """What a spawned rank does first: its torch at :data:`THREADS`
    intra-op threads."""
    torch.set_num_threads(THREADS)
