"""Scale-out: the observation-sharded BA over torch.distributed
(sharded_ba, distributed) and batched tracking of many sequences on one
card (batched_tracking)."""
