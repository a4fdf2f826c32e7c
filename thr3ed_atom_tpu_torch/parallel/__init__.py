"""Multi-device training over ``torch.distributed`` (one process a device):
meshes and their collectives (``mesh``), and a spawned dry run of the three
mesh steps (``dryrun``)."""
