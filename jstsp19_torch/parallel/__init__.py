"""Multi-process backend of the port on ``torch.distributed`` (counterpart
of ``jstsp19_tpu/parallel/``).

  mesh          ``mesh_shape_for`` and the (dp, sp, tp) ``DeviceMesh``
  distributed   the env protocol, ``initialize``, ``distributed_run_point``
                and ``distributed_run_sweep`` (a point's realizations
                shared out over the ranks), the standalone worker
  launch        ``launch``: N local ranks, one shared deadline, fail fast
  ring          ring all-reduce and the pipelined ring map over P2P sends
  sharded_admm  the proposed-ADMM step over (dp, sp, tp) shards
  dist_hybrid   the sharded step with dp or sp across processes
  scaling       weak scaling over 1, 2 and 4 ranks
  dryrun        ``python -m jstsp19_torch.parallel.dryrun N``

The modules are imported where they are used; importing this package
starts nothing.
"""
