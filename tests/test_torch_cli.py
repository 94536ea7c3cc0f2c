"""The port's command line (``align3d_torch/cli.py``) against the JAX
package's (``align3d_tpu/cli.py``): JAX odometry and viewer command lines
parse to the same values with both parsers, and the JAX flags the port
lacks are exactly those that wait for later modules (none since the viz
slice)."""

import argparse

import pytest
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_tpu import cli as jax_cli

from align3d_torch import cli

SAMPLE1 = "tests/data/rgbd/sample1"
SHARED = ("format", "dataset", "max_frames", "no_bilateral", "engine", "coarse_exact", "quiet", "save_trajectory",
          "checkpoint", "checkpoint_every", "loop_closure", "show")
VIEWER_SHARED = ("format", "dataset", "output", "max_frames", "animate", "interactive", "port")
WAITING = set()

COMMAND_LINES = [
    ["odometry", "slamtb", SAMPLE1],
    ["odometry", "slamtb", SAMPLE1, "10"],
    ["odometry", "slamtb", SAMPLE1, "5", "--engine", "pallas_v4", "--coarse-exact"],
    ["odometry", "slamtb", SAMPLE1, "--engine", "pallas", "--coarse-exact", "--no-bilateral", "-q"],
    ["odometry", "slamtb", SAMPLE1, "3", "--quiet", "--save-trajectory", "out.tum"],
    ["odometry", "slamtb", SAMPLE1, "--no-bilateral", "--engine", "xla", "--coarse-exact"],
    ["odometry", "tum", "rgbd_dataset_freiburg1_desk", "--checkpoint", "ck.npz"],
    ["odometry", "ilrgbd", "bedroom", "20", "--checkpoint", "ck.npz", "--checkpoint-every", "3", "-q"],
    ["odometry", "slamtb", SAMPLE1, "--checkpoint-every", "1", "--save-trajectory", "out.tum"],
    ["odometry", "tum", "rgbd_dataset_freiburg1_desk", "--loop-closure", "--save-trajectory", "out.tum"],
    ["odometry", "slamtb", SAMPLE1, "10", "--show", "recon.png"],
    ["odometry", "ilrgbd", "bedroom", "3", "--no-bilateral", "-q", "--show", "fly.gif"],
]
VIEWER_LINES = [
    ["viewer", "slamtb", SAMPLE1],
    ["viewer", "slamtb", SAMPLE1, "-o", "p.png", "--max-frames", "8"],
    ["viewer", "ilrgbd", "bedroom", "--output", "fly", "--animate"],
    ["viewer", "tum", "rgbd_dataset_freiburg1_desk", "--interactive", "--port", "9000", "--max-frames", "4"],
]


def _jax_parse(monkeypatch, argv):
    """The namespace JAX's parser makes of ``argv`` (its command not run)."""
    seen = []
    monkeypatch.setattr(jax_cli, "cmd_odometry", lambda args: seen.append(args) or 0)
    monkeypatch.setattr(jax_cli, "cmd_viewer", lambda args: seen.append(args) or 0)
    assert jax_cli.main(argv) == 0
    return seen[0]


@pytest.mark.parametrize("argv", COMMAND_LINES, ids=lambda a: " ".join(a[3:]) or "defaults")
def test_jax_command_lines_parse_alike(monkeypatch, argv):
    ours = cli.build_parser().parse_args(argv)
    theirs = _jax_parse(monkeypatch, argv)
    assert {k: getattr(ours, k) for k in SHARED} == {k: getattr(theirs, k) for k in SHARED}
    assert ours.fn is cli.cmd_odometry and ours.device == "cuda"


@pytest.mark.parametrize("argv", VIEWER_LINES, ids=lambda a: " ".join(a[3:]) or "defaults")
def test_jax_viewer_command_lines_parse_alike(monkeypatch, argv):
    ours = cli.build_parser().parse_args(argv)
    theirs = _jax_parse(monkeypatch, argv)
    assert {k: getattr(ours, k) for k in VIEWER_SHARED} == {k: getattr(theirs, k) for k in VIEWER_SHARED}
    assert ours.fn is cli.cmd_viewer and ours.device == "cuda"


def _flags(parser: argparse.ArgumentParser, command: str = "odometry") -> set:
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {s for a in sub.choices[command]._actions for s in a.option_strings} - {"-h", "--help"}


def test_missing_flags_are_the_queued_ones(monkeypatch, capsys):
    made, parse = [], argparse.ArgumentParser.parse_args

    def recording(self, *args, **kwargs):
        made.append(self)
        return parse(self, *args, **kwargs)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", recording)  # JAX's parser, as its main builds it
    with pytest.raises(SystemExit):
        jax_cli.main(["odometry", "--help"])
    monkeypatch.undo()
    capsys.readouterr()
    theirs = _flags(made[0])
    ours = _flags(cli.build_parser())
    assert "--coarse-exact" in ours and "-q" in ours
    assert theirs - ours == WAITING
    assert ours - theirs == {"--device"}
    assert _flags(made[0], "viewer") | {"--device"} == _flags(cli.build_parser(), "viewer")


class _Ran(Exception):
    """Raised by the stand-in for run_odometry, with the params it got."""


@pytest.mark.parametrize("flags", [[], ["--engine", "pallas"], ["--engine", "pallas_v4", "--coarse-exact"],
                                   ["--engine", "pallas", "--coarse-exact"], ["--engine", "xla", "--coarse-exact"]],
                         ids=lambda f: " ".join(f) or "defaults")
def test_engine_and_coarse_exact_pick_jaxs_params(monkeypatch, flags):
    """``--engine`` and ``--coarse-exact`` make the MsIcpParams JAX's command
    makes: a banded engine on every level, the band radius 2 at the
    coarsest, and with ``--coarse-exact`` the exact engine ("xla") there."""
    import dataclasses

    from align3d_tpu import odometry as jax_odometry

    from align3d_torch import odometry

    def stand_in(*args, icp_params=None, **kwargs):
        raise _Ran(icp_params)

    monkeypatch.setattr(odometry, "run_odometry", stand_in)
    monkeypatch.setattr(jax_odometry, "run_odometry", stand_in)
    argv = ["odometry", "slamtb", SAMPLE1, "2", "--no-bilateral", *flags]
    with pytest.raises(_Ran) as ours:
        cli.main([*argv, "--device", "cpu"])
    with pytest.raises(_Ran) as theirs:
        jax_cli.main(argv)
    ours, theirs = ours.value.args[0], theirs.value.args[0]
    assert [dataclasses.asdict(p) for p in ours] == [dataclasses.asdict(p) for p in theirs]
    engine = flags[1] if flags else "xla"
    coarse = "xla" if "--coarse-exact" in flags else engine
    assert [p.engine for p in ours] == [engine, engine, coarse]
    assert [p.band_radius for p in ours] == ([1, 1, 1] if engine == "xla" else [1, 1, 2])


@pytest.mark.parametrize("value", ["0", "-2"])
def test_checkpoint_every_below_one_is_refused_by_both(monkeypatch, capsys, value):
    argv = ["odometry", "slamtb", SAMPLE1, "--checkpoint-every", value]
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(argv)
    with pytest.raises(SystemExit):
        _jax_parse(monkeypatch, argv)
    assert "must be >= 1" in capsys.readouterr().err
