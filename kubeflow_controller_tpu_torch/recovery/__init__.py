"""Recovery plane, workload half: the gang guard (``rendezvous``)."""
