"""The benchmark's harness: finds a cell's configuration, traffic, request
kind, metric readers and kernel counts by name, runs the cell on the port,
and prints the one result line.

Everything that belongs to one configuration, traffic mix, request kind,
per-layer metric, span or kernel lives in a file of its own under
``benchmark/`` (``configs/``, ``traffic/``, ``requests/``, ``metrics/``,
``spans/``, ``kernels/``, ``scenes/``), found by the name that
``BENCHMARK.json`` or another such file gives.  A new cell, mix, metric or
kernel count is a new file; no file here needs an edit for it.

A request kind (``requests/<kind>.py``) defines ``Traffic(params, seed,
pts, scene, config)`` with: ``prepare(sess, api, tracer)`` (the state the
requests need, in set-up), ``warm_ids()`` (the ids warmed up; the window
goes on from the next), ``before(sess, api, tracer, i)`` (untimed work
before request ``i``), ``request(sess, api, tracer, i)`` (the timed request;
returns its outputs), ``key(i)`` (what a request's data-dependent kernel work
depends on), ``host(out)``, ``replay(sess, api, ids)`` (the same requests on
the reference's session) and ``compare(got, ref)`` (the numbers held to the
traffic's ``limits``).  A metric reader (``metrics/<name>.py``) defines
``read(run)``, returning None where it finds nothing, and may name the
``SPANS`` and ``KERNELS`` it reads.
"""
