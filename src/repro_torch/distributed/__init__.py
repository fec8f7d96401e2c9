"""Distribution of the port: sharding rules as DTensor placements,
collectives over ``torch.distributed`` and elastic resharding."""
