"""Host core of the port: settings, blocks, graph, compiler, scheduler."""
