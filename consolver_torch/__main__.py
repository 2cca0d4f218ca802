"""Unified CLI: ``python -m consolver_torch <command> [args...]``.

Port of ``consolver_tpu/__main__.py``: one front door over the commands,
each a module of ``consolver_torch/cli/`` named after the JAX script, whose
``main(argv)`` takes the rest of the command line:

  train-sd        PPO-train the SD-1.5 consistency solver (cli/train_sd15.py)
  train-flux      PPO-train the FLUX-Kontext edit solver (cli/train_flux.py)
  generate        text-to-image sweeps over the solver zoo (cli/generate.py)
  generate-edit   kontext-bench edit generation (cli/generate_edit.py)
  generate-teacher  teacher trajectory sets, both families (cli/generate_teacher.py)
  evaluate        consistency / fid / edit-score metrics (cli/evaluate.py)
  serve           HTTP serving, t2i + edit engines (cli/serve.py)
  convert         hub checkpoint -> port component conversion (cli/convert_checkpoints.py)
  quantize        int8/int4 serving checkpoints (cli/quantize_checkpoint.py)
  preview         preview/refine product demo (cli/preview_demo.py)
  selftest        end-to-end eval-chain selftest (cli/selftest_eval.py)

Every command runs on the card unless it is given ``--device cpu``, and
raises when there is no card.  ``python -m consolver_torch <command>
--help`` shows the command's own flags.
"""

from __future__ import annotations

import importlib
import sys

_COMMANDS = {
    "train-sd": "train_sd15",
    "train-flux": "train_flux",
    "generate": "generate",
    "generate-edit": "generate_edit",
    "generate-teacher": "generate_teacher",
    "evaluate": "evaluate",
    "serve": "serve",
    "convert": "convert_checkpoints",
    "quantize": "quantize_checkpoint",
    "preview": "preview_demo",
    "selftest": "selftest_eval",
}


def _usage() -> str:
    lines = ["usage: python -m consolver_torch <command> [args...]", "", "commands:"]
    lines += [f"  {name}" for name in _COMMANDS]
    lines.append("")
    lines.append("run `python -m consolver_torch <command> --help` for per-command flags")
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        return 0
    cmd = argv[0]
    if cmd not in _COMMANDS:
        print(f"unknown command: {cmd!r}\n\n{_usage()}", file=sys.stderr)
        return 2
    module = importlib.import_module(f"consolver_torch.cli.{_COMMANDS[cmd]}")
    try:
        module.main(argv[1:])
    except SystemExit as e:  # argparse's --help and errors, and the commands' own exits
        if isinstance(e.code, str):
            print(e.code, file=sys.stderr)
            return 2
        return e.code or 0
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
