import torch.distributed as dist

from tsxcount_tpu_torch.cli import main

if __name__ == "__main__":
    rc = main()
    if dist.is_initialized():  # a rank's group (--shards N >= 2)
        dist.destroy_process_group()
    raise SystemExit(rc)
