"""The laws that draw a graph's edges, one module a law, found by the name
in a configuration's ``graph["law"]``: ``pairs(graph, count, gen) ->
(senders, receivers)``, ``count`` int64 pairs of distinct nodes drawn on
``gen``'s device."""
