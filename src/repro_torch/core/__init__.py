"""The port's algorithms: topology, consensus, linear algebra, S-DOT."""
