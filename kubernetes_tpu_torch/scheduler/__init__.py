"""The scheduler's host side around TorchBatchScheduler: the scheduler
cache (cache.py), the queue's pod identities (queue.py), the metrics the
preemption path records (metrics.py) and the PostFilter preemption
evaluator (preemption.py).  The scheduling loop itself is not ported yet.
"""
