"""`python -m tepose_tpu_torch.train`: see `tepose_tpu_torch.train.run`."""

from tepose_tpu_torch.train.run import main

if __name__ == "__main__":
    main()
