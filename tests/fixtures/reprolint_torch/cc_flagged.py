"""Flagged fixture: every CC1xx rule fires at least once.

Not imported by anything — reprolint reads it as text. The class is named
``NetworkGraph`` because that name is what scopes CC101-103."""


class NetworkGraph:
    def drift(self, l, bw):
        # CC101: capacity moved, capacity_version did not
        self.capacity[l] = bw

    def kill(self, u, v):
        # CC102 + CC103: adjacency moved; no epoch bump, no cache drop
        self._adj[u].discard(v)
        self._adj[v].discard(u)

    def kill_half_right(self, u, v):
        # CC103 only: epoch bumped but the host memos keep dead-link paths
        self._adj[u].discard(v)
        self.topology_version += 1


def external_poke(net, l, bw):
    # CC104: capacity write outside the class
    net.capacity[l] = bw


def external_sever(net, u, v):
    # CC104: adjacency mutation outside the class
    net._adj[u].discard(v)
