"""A cell's operation counts, one module a kind of sweep:
``<name>.py`` defines ``count(spec, net)``, which returns the sweep's
counted operations (``sweep_flops``) and, where the sweep runs the dense
node scan, the scan's (``node_scan_flops``, ``node_scan_bytes``), from the
cell's shapes (``spec``) and the network's edge count (``net['edges']``,
its nonzero entries over every row and time)."""
