"""The port's side of the cluster: a host's cards (``topology``) and the
slice inventory that binds gangs to them (``gpu``)."""
