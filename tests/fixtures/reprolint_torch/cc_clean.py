"""Clean fixture: the same mutations done right — zero CC findings."""


class NetworkGraph:
    def drift(self, l, bw):
        self.capacity[l] = bw
        self.capacity_version += 1

    def kill(self, u, v):
        self._adj[u].discard(v)
        self._adj[v].discard(u)
        self.topology_version += 1
        self.capacity_version += 1
        self._prune_host_caches(0)

    def revive(self, u, v):
        self._adj[u].add(v)
        self._adj[v].add(u)
        self.topology_version += 1
        self.capacity_version += 1
        self._drop_host_caches()


def external_ok(net, u, v):
    # mutating through the churn API is the sanctioned path
    net.fail_link(u, v)
    net.recover_link(u, v)
