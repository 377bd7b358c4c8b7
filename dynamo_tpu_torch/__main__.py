"""``python -m dynamo_tpu_torch`` → the dynamo-tpu-torch CLI (cli.py)."""

from dynamo_tpu_torch.cli import main

if __name__ == "__main__":
    main()
