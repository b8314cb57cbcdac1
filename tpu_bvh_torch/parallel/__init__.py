"""Multi-device paths over `torch.distributed` ranks: the port of
`tpu_bvh.parallel`. `comm` wraps the process group under JAX's collective
names and starts ranks; `sharded` shards batches, rays and raster strips;
`sharded_build` builds one scene sharded over the ranks; `dryrun` runs
them all once at tiny shapes."""
