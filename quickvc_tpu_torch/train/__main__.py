"""``python -m quickvc_tpu_torch.train``: see :mod:`quickvc_tpu_torch.train.loop`."""

from quickvc_tpu_torch.train.loop import main

if __name__ == "__main__":
    main()
