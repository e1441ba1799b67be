from .sharded import (  # noqa: F401
    all_gather_rows, allreduce_sum_, barrier, broadcast_, init_dp, is_main,
    main_first, rank, share, shutdown, world)
