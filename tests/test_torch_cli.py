"""The port's command line (``align3d_torch/cli.py``) against the JAX
package's (``align3d_tpu/cli.py``): JAX odometry command lines that use only
flags the port has parse to the same values with both parsers, and the JAX
flags the port lacks are exactly those that wait for later modules
(ROADMAP Queue 1: the viewer)."""

import argparse

import pytest

from align3d_tpu import cli as jax_cli

from align3d_torch import cli

SAMPLE1 = "tests/data/rgbd/sample1"
SHARED = ("format", "dataset", "max_frames", "no_bilateral", "engine", "coarse_exact", "quiet", "save_trajectory",
          "checkpoint", "checkpoint_every", "loop_closure")
WAITING = {"--show"}

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
]


def _jax_parse(monkeypatch, argv):
    """The namespace JAX's parser makes of ``argv`` (its command not run)."""
    seen = []
    monkeypatch.setattr(jax_cli, "cmd_odometry", lambda args: seen.append(args) or 0)
    assert jax_cli.main(argv) == 0
    return seen[0]


@pytest.mark.parametrize("argv", COMMAND_LINES, ids=lambda a: " ".join(a[3:]) or "defaults")
def test_jax_command_lines_parse_alike(monkeypatch, argv):
    ours = cli.build_parser().parse_args(argv)
    theirs = _jax_parse(monkeypatch, argv)
    assert {k: getattr(ours, k) for k in SHARED} == {k: getattr(theirs, k) for k in SHARED}
    assert ours.fn is cli.cmd_odometry and ours.device == "cuda"


def _odometry_flags(parser: argparse.ArgumentParser) -> set:
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {s for a in sub.choices["odometry"]._actions for s in a.option_strings} - {"-h", "--help"}


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
    theirs = _odometry_flags(made[0])
    ours = _odometry_flags(cli.build_parser())
    assert "--coarse-exact" in ours and "-q" in ours
    assert theirs - ours == WAITING
    assert ours - theirs == {"--device"}


@pytest.mark.parametrize("value", ["0", "-2"])
def test_checkpoint_every_below_one_is_refused_by_both(monkeypatch, capsys, value):
    argv = ["odometry", "slamtb", SAMPLE1, "--checkpoint-every", value]
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(argv)
    with pytest.raises(SystemExit):
        _jax_parse(monkeypatch, argv)
    assert "must be >= 1" in capsys.readouterr().err
