"""The port's logging, `info` and command-line parity with the JAX
package's CLI, on the CPU: setup_logging's file, format and handlers
against seld_tpu.utils.logging's; a failing command returns 1 and logs
"<command> failed" with its exception; `info --device cpu` prints JAX's
keys, and without a card and without --device cpu returns 1; the two
argparse trees differ only where the port means to (--device,
--checkpoint, export --platforms, migrate-ckpt), so every subcommand takes
--synthetic as JAX's does; and the config fields the port lacks."""

import argparse
import dataclasses
import json
import logging
import re
import sys
from pathlib import Path
from unittest import mock

import pytest
import torch

import seld_tpu.cli as jax_cli
from seld_tpu.config import Config as JaxConfig
from seld_tpu.utils import logging as jax_logging
from seld_tpu_torch import config as pc
from seld_tpu_torch.cli import build_parser
from seld_tpu_torch.cli import main as port_main
from seld_tpu_torch.utils import logging as port_logging
from seld_tpu_torch.utils.platform import describe_devices
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_cli_helpers import port_fails, printed_json

def line_of(name: str) -> str:
    """The regex of the record "hello 7" of logger `name` in the format."""
    return r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d - " + name + " - INFO - hello 7"


@pytest.fixture
def restore_loggers():
    """Both packages' loggers as they were: setup_logging replaces handlers
    that later tests' records would reach."""
    saved = {}
    for name in ("seld_tpu", "seld_tpu_torch"):
        log = logging.getLogger(name)
        saved[name] = (list(log.handlers), log.level, log.propagate)
    yield
    for name, (handlers, level, propagate) in saved.items():
        log = logging.getLogger(name)
        for h in log.handlers:
            if h not in handlers:
                log.removeHandler(h)
                h.close()
        for h in handlers:
            if h not in log.handlers:
                log.addHandler(h)
        log.setLevel(level)
        log.propagate = propagate


def test_setup_logging_file_and_format_match_jax(tmp_path, capsys, restore_loggers):
    jlog, jfile = jax_logging.setup_logging(str(tmp_path / "j"), experiment_name="run")
    plog, pfile = port_logging.setup_logging(str(tmp_path / "p"), experiment_name="run")
    assert re.fullmatch(r"run_\d{8}_\d{6}\.log", Path(pfile).name)
    assert Path(pfile).parent == tmp_path / "p" and Path(jfile).name[:4] == "run_"
    assert plog is logging.getLogger("seld_tpu_torch") and plog.level == logging.INFO
    jfmt = [h.formatter for h in jlog.handlers]
    pfmt = [h.formatter for h in plog.handlers if getattr(h, "_seld_setup", False)]
    assert [(f._fmt, f.datefmt) for f in pfmt] == [(f._fmt, f.datefmt) for f in jfmt]
    (fh,) = [h for h in plog.handlers if isinstance(h, logging.FileHandler)]
    (sh,) = [h for h in plog.handlers if not isinstance(h, logging.FileHandler)]
    assert fh.baseFilename == str(Path(pfile).absolute()) and sh.stream is sys.stdout
    capsys.readouterr()
    jlog.info("hello %d", 7)
    plog.getChild("train.trainer").info("hello %d", 7)  # a module's logger reaches both
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(line_of("seld_tpu"), out[0])
    assert re.fullmatch(line_of(r"seld_tpu_torch\.train\.trainer"), out[1])
    assert re.fullmatch(line_of(r"seld_tpu_torch\.train\.trainer"),
                        Path(pfile).read_text().strip())
    # a second setup closes the first's handlers, and keeps a caller's
    first = list(plog.handlers)
    keep = logging.NullHandler()
    plog.addHandler(keep)
    port_logging.setup_logging(str(tmp_path / "p"), experiment_name="again")
    assert all(h.stream is None for h in first if isinstance(h, logging.FileHandler))
    assert keep in plog.handlers and len(plog.handlers) == 3
    port_logging.close_logging()
    assert plog.handlers == [keep]


def test_a_failing_command_returns_1_and_logs_it(tmp_path, capsys, restore_loggers):
    exc = port_fails(["info", "--device", "cpu", "train.not_a_field=1"], KeyError, "not_a_field")
    out = capsys.readouterr().out
    assert "seld_tpu_torch - ERROR - info failed" in out and "Traceback" in out
    assert re.search(r"seld_tpu_torch - INFO - Log file: logs/seld_tpu_torch_info_\d{8}_\d{6}"
                     r"\.log", out)
    # the JAX package's CLI on the same line
    assert jax_cli.main(["info", "train.not_a_field=1"]) == 1
    assert type(exc).__name__ in capsys.readouterr().out
    with pytest.raises(SystemExit):  # argparse's errors stay outside
        port_main(["info", "--no-such-flag"])


def test_info_prints_jax_s_keys(capsys, restore_loggers):
    assert port_main(["info", "--device", "cpu", "--synthetic", "train.batch_size=4"]) == 0
    got = printed_json(capsys.readouterr().out)
    assert jax_cli.main(["info"]) == 0
    out = capsys.readouterr().out
    want = json.loads(out[out.index("{\n"):])
    assert got.keys() == want.keys() == {"devices", "config"}
    assert got["devices"].keys() == want["devices"].keys()
    assert got["devices"]["platform"] == "cpu" and got["devices"]["device_count"] == 1
    assert got["config"] == json.loads(json.dumps(
        pc.config_to_dict(pc.parse_overrides(pc.Config(), ["train.batch_size=4"]))))
    assert got["config"].keys() == want["config"].keys()
    info = describe_devices("cpu")
    assert info["default_backend"] == "cpu" and len(info["devices"]) == 1


def test_info_without_a_card_returns_1(monkeypatch, restore_loggers):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port_fails(["info"], RuntimeError, "no CUDA device is visible")
    port_fails(["import-torch", "--torch-checkpoint", "x.pth"], RuntimeError, "CUDA")


def _tree(parser):
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {tuple(a.option_strings) or (a.dest,) for a in p._actions
                   if a.dest != "help"} for name, p in sub.choices.items()}


def _jax_parser():
    """The parser seld_tpu.cli.main builds (it builds it inside main)."""
    captured = {}

    def grab(self, argv=None, namespace=None):
        captured["parser"] = self
        raise SystemExit(0)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab), \
            pytest.raises(SystemExit):
        jax_cli.main(["info"])
    return captured["parser"]


def test_argparse_trees_differ_only_where_meant():
    jax_tree, port = _tree(_jax_parser()), _tree(build_parser())
    assert set(jax_tree) - set(port) == {"migrate-ckpt"} and set(port) <= set(jax_tree)
    diff = {}
    for name in port:
        only_jax, only_port = jax_tree[name] - port[name], port[name] - jax_tree[name]
        if only_jax or only_port:
            diff[name] = (sorted(only_jax), sorted(only_port))
    device, ckpt = ("--device",), ("--checkpoint",)
    assert diff == {
        "calibrate": ([], [device]), "eval": ([], [device]), "train": ([], [device]),
        "verify": ([], [device]), "info": ([], [device]), "import-torch": ([], [device]),
        "predict": ([], [ckpt, device]), "serve": ([], [ckpt, device]),
        "export": ([("--platforms",)], [ckpt, device]),
    }
    for name in jax_tree:
        if name != "migrate-ckpt":
            assert ("--synthetic",) in port[name], name


@pytest.mark.parametrize("argv", [
    ["verify", "--frames", "2"], ["predict", "--wavs", "a.wav"], ["export", "--out", "a.pt2"],
    ["score", "--pred-dir", "p", "--gt-dir", "g"], ["serve", "--port", "0"],
    ["average-ckpts", "--checkpoint-dir", "c", "--output-dir", "o"], ["info"],
    ["import-torch", "--torch-checkpoint", "a.pth"], ["train"], ["eval"], ["calibrate"]])
def test_every_subcommand_takes_synthetic(argv):
    assert build_parser().parse_args([*argv, "--synthetic"]).synthetic is True
    assert build_parser().parse_args(argv).synthetic is False


def _fields(obj, prefix=""):
    out = {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if dataclasses.is_dataclass(value):
            out.update(_fields(value, f"{f.name}."))
        else:
            out[prefix + f.name] = value
    return out


def test_the_port_lacks_exactly_eight_jax_config_fields():
    jax_fields, port_fields = _fields(JaxConfig()), _fields(pc.Config())
    assert set(jax_fields) - set(port_fields) == {
        "train.prng_impl", "mesh.shard_opt_state", "mesh.shard_params", "features.power",
        "features.top_db", "features.use_pallas", "targets.max_rows_per_chunk",
        "train.log_every_steps"}
    assert set(port_fields) <= set(jax_fields)
    assert port_fields["train.profile_steps"] == jax_fields["train.profile_steps"] == 0
    differ = {k for k in port_fields if port_fields[k] != jax_fields[k]}
    assert not differ, differ


def test_logs_reach_a_capture_of_the_root_logger(tmp_path, caplog, restore_loggers):
    """Records propagate (pytest's caplog listens on the root logger), and
    the root has no handler of the package's, so nothing prints twice."""
    port_logging.setup_logging(str(tmp_path), experiment_name="propagate")
    with caplog.at_level(logging.INFO):
        logging.getLogger("seld_tpu_torch.cli").info("seen %s", "once")
    assert caplog.messages == ["seen once"]
    assert not [h for h in logging.getLogger().handlers if getattr(h, "_seld_setup", False)]
