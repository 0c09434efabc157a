"""Row-partitioned solves over ``torch.distributed`` (``dist_gmres.py``)."""
