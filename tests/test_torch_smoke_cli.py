"""`fresnel-torch smoke` checks the card: it is in the parser, and with no
card it says so in one line and exits 1 (it runs nothing on the CPU)."""

import pytest
import torch

from fresnel_tpu_torch import cli
from test_torch_threads import _few_threads  # noqa: F401


def test_parser_has_smoke():
    assert cli.build_parser().parse_args(["smoke"]).cmd == "smoke"


def test_smoke_without_a_card_says_so_and_exits_one(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["smoke"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and "CUDA is not available" in out[0]


def test_smoke_takes_no_arguments():
    with pytest.raises(SystemExit):
        cli.main(["smoke", "--device", "cpu"])
