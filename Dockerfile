# =====================================================================
# flexpart_tpu container (the reference's 3-stage Dockerfile analog,
# /root/reference/Dockerfile:10-47, re-based on JAX):
#   builder: compiles the native GRIB decoder (native/gribdec)
#   tester:  runs the full pytest suite on the 8-device virtual CPU mesh
#            (JAX's CPU wheel)
#   runner:  operational image for NVIDIA GPUs: JAX with its CUDA plugin,
#            exposing the FLEXPART-compatible CLI (python -m flexpart_tpu),
#            the service layer (python -m flexpart_tpu.service) and the
#            on-device smoke test (python chip_smoke.py)
#
# Build:  docker build --target runner -t flexpart-jax .
# Run:    docker run --gpus all flexpart-jax            (needs a GPU host)
# Test:   docker build --target tester -t flexpart-jax-test . \
#           && docker run --rm flexpart-jax-test
# =====================================================================

FROM python:3.12-slim AS builder
RUN apt-get update && apt-get install -y --no-install-recommends \
        g++ make && rm -rf /var/lib/apt/lists/*
WORKDIR /opt/app
COPY native /opt/app/native
RUN make -C native/gribdec

FROM python:3.12-slim AS base
RUN pip install --no-cache-dir numpy scipy h5py
WORKDIR /opt/app
COPY flexpart_tpu /opt/app/flexpart_tpu
COPY scripts /opt/app/scripts
COPY bench.py bench_suite.py chip_smoke.py __graft_entry__.py /opt/app/
COPY --from=builder /opt/app/native/gribdec /opt/app/native/gribdec
ENV PYTHONPATH=/opt/app

FROM base AS tester
RUN pip install --no-cache-dir "jax[cpu]" pytest
COPY tests /opt/app/tests
# the suite forces the 8-device virtual CPU mesh itself (tests/conftest.py)
CMD ["python", "-m", "pytest", "tests/", "-q"]

FROM base AS runner
RUN pip install --no-cache-dir "jax[cuda12]"
ENTRYPOINT ["python", "-m", "flexpart_tpu"]
CMD ["pathnames", "-v"]
