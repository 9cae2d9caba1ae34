"""python -m vec_vad_torch <subcommand> (see vec_vad_torch/cli.py)."""

from vec_vad_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
