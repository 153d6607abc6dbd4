"""Deployment utilities: model packaging, data-channel organization, S3
upload, and AWS SageMaker endpoint / batch-transform management (the JAX
package's ``serving/deploy.py``; nothing here touches the card).

The pure-Python pieces (packaging, channel prep, request-spec assembly)
mirror the reference ``sagemaker/sagemaker_utils.py``:
``create_model_package`` (:23-60), ``prepare_training_data`` (:522-585),
``SageMakerEndpoint`` (:209-368), ``SageMakerBatchTransform`` (:371-472),
``upload_data_to_s3`` (:479-519) and the utils CLI (:592-636).

Instead of the high-level ``sagemaker`` SDK (PyTorchModel / Transformer),
the wrappers assemble plain SageMaker API request dicts
(``build_model_spec`` / ``build_endpoint_config_spec`` /
``build_transform_job_spec``) and submit them through boto3 clients that
are injectable, so all deployment logic runs without AWS credentials and
only the final ``client.create_*`` call needs the SDK. A package holds a
port run directory (``cli/train.py``'s output directory) or an exported
bundle (``cli/export.py``); ``extract_model_package`` unpacks it where
``serving/handler.model_fn`` serves it.
"""

from __future__ import annotations

import fnmatch
import os
import shutil
import tarfile
from pathlib import Path
from typing import Any, Dict, List, Optional


def create_model_package(
    model_dir: str,
    output_path: str = "model.tar.gz",
    extra_files: Optional[List[str]] = None,
) -> str:
    """Pack a run directory (checkpoints + inference/tokenizer assets) into a
    tar.gz deployable archive, each file once. (The JAX package adds every
    directory recursively and then its files again, so that each file below
    the top level is in its archive twice.)"""
    model_dir = Path(model_dir)
    if not model_dir.is_dir():
        raise FileNotFoundError(f"model dir not found: {model_dir}")
    with tarfile.open(output_path, "w:gz") as tar:
        for item in sorted(model_dir.rglob("*")):
            tar.add(item, arcname=item.relative_to(model_dir), recursive=False)
        for extra in extra_files or []:
            tar.add(extra, arcname=os.path.basename(extra))
    return output_path


def extract_model_package(archive_path: str, target_dir: str) -> str:
    with tarfile.open(archive_path, "r:gz") as tar:
        tar.extractall(target_dir, filter="data")
    return target_dir


def prepare_training_data(
    train_csv: str,
    val_csv: str,
    out_dir: str,
    test_csv: Optional[str] = None,
    image_dir: Optional[str] = None,
) -> Dict[str, str]:
    """Organize CSVs (+ images) into per-channel directories matching the
    entrypoint's channel layout (reference sagemaker_utils.py:522-585)."""
    out = Path(out_dir)
    channels: Dict[str, str] = {}

    def add(channel: str, csv_path: Optional[str]):
        if not csv_path:
            return
        ch_dir = out / channel
        ch_dir.mkdir(parents=True, exist_ok=True)
        shutil.copy2(csv_path, ch_dir / "data.csv")
        channels[channel] = str(ch_dir)

    add("train", train_csv)
    add("validation", val_csv)
    add("test", test_csv)
    if image_dir and os.path.isdir(image_dir):
        img_out = out / "images"
        if not img_out.exists():
            shutil.copytree(image_dir, img_out)
        channels["images"] = str(img_out)
    return channels


def _require_sagemaker():
    try:
        import boto3  # noqa: F401
        import sagemaker  # noqa: F401
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "AWS deployment wrappers need the `sagemaker` and `boto3` "
            "packages, which the port does not require. The serving "
            "handler (serving/handler.py) and the training entrypoint "
            "(serving/entrypoint.py) are cloud-agnostic and run anywhere."
        ) from e


class SageMakerTrainingJob:  # pragma: no cover - AWS-SDK glue
    """Estimator wrapper (reference sagemaker_utils.py:63-206)."""

    def __init__(self, role: str, instance_type: str = "ml.g4dn.xlarge", **kwargs):
        _require_sagemaker()
        import sagemaker
        from sagemaker.pytorch import PyTorch

        self.session = sagemaker.Session()
        self.estimator = PyTorch(
            entry_point="entrypoint.py",
            source_dir=os.path.dirname(__file__),
            role=role,
            instance_count=1,
            instance_type=instance_type,
            framework_version=kwargs.pop("framework_version", "2.1"),
            py_version=kwargs.pop("py_version", "py310"),
            hyperparameters=kwargs.pop("hyperparameters", {}),
            **kwargs,
        )

    def fit(self, channels: Dict[str, str], wait: bool = True):
        self.estimator.fit(channels, wait=wait)
        return self.estimator


# ---------------------------------------------------------------------------
# Request-spec builders (pure logic; unit-tested without AWS)
# ---------------------------------------------------------------------------


def build_model_spec(
    model_name: str,
    image_uri: str,
    model_data_url: str,
    role: str,
    env: Optional[Dict[str, str]] = None,
) -> Dict[str, Any]:
    """CreateModel request body (reference deploys via PyTorchModel,
    sagemaker_utils.py:284-292; this is the underlying API contract)."""
    if not model_data_url.startswith("s3://"):
        raise ValueError(f"model_data_url must be an s3:// URI: {model_data_url}")
    return {
        "ModelName": model_name,
        "PrimaryContainer": {
            "Image": image_uri,
            "ModelDataUrl": model_data_url,
            "Environment": dict(env or {}),
        },
        "ExecutionRoleArn": role,
    }


def build_endpoint_config_spec(
    config_name: str,
    model_name: str,
    instance_type: str = "ml.g4dn.xlarge",
    instance_count: int = 1,
) -> Dict[str, Any]:
    """CreateEndpointConfig request body (single production variant, same
    defaults as reference sagemaker_utils.py:258-262)."""
    if instance_count < 1:
        raise ValueError("instance_count must be >= 1")
    return {
        "EndpointConfigName": config_name,
        "ProductionVariants": [
            {
                "VariantName": "AllTraffic",
                "ModelName": model_name,
                "InstanceType": instance_type,
                "InitialInstanceCount": instance_count,
                "InitialVariantWeight": 1.0,
            }
        ],
    }


def build_transform_job_spec(
    job_name: str,
    model_name: str,
    input_s3: str,
    output_s3: str,
    instance_type: str = "ml.g4dn.xlarge",
    instance_count: int = 1,
    content_type: str = "application/jsonlines",
    accept: str = "application/jsonlines",
    split_type: str = "Line",
) -> Dict[str, Any]:
    """CreateTransformJob request body for JSONL batch scoring (reference
    sagemaker_utils.py:416-472; JSONL with per-line split matches the
    handler's BatchTransformHandler contract)."""
    for uri, what in ((input_s3, "input_s3"), (output_s3, "output_s3")):
        if not uri.startswith("s3://"):
            raise ValueError(f"{what} must be an s3:// URI: {uri}")
    return {
        "TransformJobName": job_name,
        "ModelName": model_name,
        "TransformInput": {
            "DataSource": {
                "S3DataSource": {"S3DataType": "S3Prefix", "S3Uri": input_s3}
            },
            "ContentType": content_type,
            "SplitType": split_type,
        },
        "TransformOutput": {
            "S3OutputPath": output_s3,
            "Accept": accept,
            "AssembleWith": "Line" if split_type == "Line" else "None",
        },
        "TransformResources": {
            "InstanceType": instance_type,
            "InstanceCount": instance_count,
        },
    }


def upload_data_to_s3(
    local_dir: str,
    bucket: str,
    prefix: str,
    include_patterns: Optional[List[str]] = None,
    s3_client=None,
) -> str:
    """Upload a local directory tree to s3://bucket/prefix (reference
    sagemaker_utils.py:479-519). ``include_patterns`` are fnmatch globs on
    file basenames; ``s3_client`` is injectable for tests."""
    if s3_client is None:  # pragma: no cover - needs AWS
        _require_sagemaker()
        import boto3

        s3_client = boto3.client("s3")
    prefix = prefix.strip("/")
    for root, _dirs, files in os.walk(local_dir):
        for fname in sorted(files):
            if include_patterns and not any(
                fnmatch.fnmatch(fname, p) for p in include_patterns
            ):
                continue
            local_path = os.path.join(root, fname)
            rel = os.path.relpath(local_path, local_dir)
            s3_client.upload_file(local_path, bucket, f"{prefix}/{rel}")
    return f"s3://{bucket}/{prefix}"


class SageMakerEndpoint:
    """Create/deploy/predict/delete wrapper (reference sagemaker_utils.py:
    209-368), over injectable boto3 clients."""

    def __init__(self, endpoint_name: str, client=None, runtime=None):
        if client is None or runtime is None:  # pragma: no cover - needs AWS
            _require_sagemaker()
            import boto3

            client = client or boto3.client("sagemaker")
            runtime = runtime or boto3.client("sagemaker-runtime")
        self.endpoint_name = endpoint_name
        self.runtime = runtime
        self.client = client

    def deploy(
        self,
        model_data: str,
        role: str,
        image_uri: str,
        instance_type: str = "ml.g4dn.xlarge",
        instance_count: int = 1,
        env: Optional[Dict[str, str]] = None,
        wait: bool = True,
    ) -> "SageMakerEndpoint":
        """Create model -> endpoint config -> endpoint (returns self for
        chaining, like the reference's ``deploy``)."""
        model_name = f"{self.endpoint_name}-model"
        config_name = f"{self.endpoint_name}-config"
        self.client.create_model(
            **build_model_spec(model_name, image_uri, model_data, role, env)
        )
        self.client.create_endpoint_config(
            **build_endpoint_config_spec(
                config_name, model_name, instance_type, instance_count
            )
        )
        self.client.create_endpoint(
            EndpointName=self.endpoint_name, EndpointConfigName=config_name
        )
        if wait:  # pragma: no cover - long-poll against AWS
            waiter = self.client.get_waiter("endpoint_in_service")
            waiter.wait(EndpointName=self.endpoint_name)
        return self

    def predict(self, payload: dict) -> dict:
        import json

        resp = self.runtime.invoke_endpoint(
            EndpointName=self.endpoint_name,
            ContentType="application/json",
            Body=json.dumps(payload),
        )
        return json.loads(resp["Body"].read())

    def delete(self):
        """Delete endpoint + its config + model (full cleanup, reference
        sagemaker_utils.py:355-368)."""
        self.client.delete_endpoint(EndpointName=self.endpoint_name)
        self.client.delete_endpoint_config(
            EndpointConfigName=f"{self.endpoint_name}-config"
        )
        self.client.delete_model(ModelName=f"{self.endpoint_name}-model")


class SageMakerBatchTransform:
    """JSONL batch-transform wrapper (reference sagemaker_utils.py:371-472)."""

    def __init__(
        self,
        model_data: str,
        role: str,
        image_uri: str = "",
        instance_type: str = "ml.g4dn.xlarge",
        instance_count: int = 1,
        client=None,
    ):
        if client is None:  # pragma: no cover - needs AWS
            _require_sagemaker()
            import boto3

            client = boto3.client("sagemaker")
        self.model_data = model_data
        self.role = role
        self.image_uri = image_uri
        self.instance_type = instance_type
        self.instance_count = instance_count
        self.client = client

    def run(
        self,
        input_s3: str,
        output_s3: str,
        job_name: Optional[str] = None,
        content_type: str = "application/jsonlines",
        accept: str = "application/jsonlines",
        env: Optional[Dict[str, str]] = None,
        wait: bool = True,
    ) -> str:
        """Create this job's model and run one transform job; returns the
        output S3 URI (same contract as reference ``run``). Job/model names
        must be unique per AWS account, so the default gets a random suffix."""
        if job_name is None:
            import uuid

            job_name = f"mmharm-batch-transform-{uuid.uuid4().hex[:8]}"
        model_name = f"{job_name}-model"
        self.client.create_model(
            **build_model_spec(
                model_name, self.image_uri, self.model_data, self.role, env
            )
        )
        self.client.create_transform_job(
            **build_transform_job_spec(
                job_name,
                model_name,
                input_s3,
                output_s3,
                self.instance_type,
                self.instance_count,
                content_type,
                accept,
            )
        )
        if wait:  # pragma: no cover - long-poll against AWS
            waiter = self.client.get_waiter("transform_job_completed_or_stopped")
            waiter.wait(TransformJobName=job_name)
        return output_s3


# ---------------------------------------------------------------------------
# Utils CLI (reference sagemaker_utils.py:592-636 + deploy/transform/upload)
# ---------------------------------------------------------------------------


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Deployment utilities")
    sub = parser.add_subparsers(dest="command")

    pkg = sub.add_parser("package", help="Create model.tar.gz package")
    pkg.add_argument("--model-dir", required=True)
    pkg.add_argument("--output", required=True)

    data = sub.add_parser("prepare-data", help="Organize data channels")
    data.add_argument("--train-csv", required=True)
    data.add_argument("--val-csv", required=True)
    data.add_argument("--test-csv", default=None)
    data.add_argument("--image-root", default=None)
    data.add_argument("--output-dir", required=True)

    up = sub.add_parser("upload", help="Upload a directory to S3")
    up.add_argument("--local-dir", required=True)
    up.add_argument("--bucket", required=True)
    up.add_argument("--prefix", required=True)
    up.add_argument("--include", nargs="*", default=None)

    dep = sub.add_parser("deploy", help="Deploy an endpoint")
    dep.add_argument("--endpoint-name", required=True)
    dep.add_argument("--model-data", required=True)
    dep.add_argument("--role", required=True)
    dep.add_argument("--image-uri", required=True)
    dep.add_argument("--instance-type", default="ml.g4dn.xlarge")
    dep.add_argument("--instance-count", type=int, default=1)
    dep.add_argument("--no-wait", action="store_true")

    tr = sub.add_parser("transform", help="Run a JSONL batch-transform job")
    tr.add_argument("--job-name", default=None)
    tr.add_argument("--model-data", required=True)
    tr.add_argument("--role", required=True)
    tr.add_argument("--image-uri", required=True)
    tr.add_argument("--input-s3", required=True)
    tr.add_argument("--output-s3", required=True)
    tr.add_argument("--instance-type", default="ml.g4dn.xlarge")
    tr.add_argument("--instance-count", type=int, default=1)

    args = parser.parse_args(argv)
    if args.command == "package":
        out = create_model_package(args.model_dir, args.output)
        print(f"Created model package: {out}")
    elif args.command == "prepare-data":
        channels = prepare_training_data(
            args.train_csv, args.val_csv, args.output_dir,
            test_csv=args.test_csv, image_dir=args.image_root,
        )
        print(f"Prepared data channels: {channels}")
    elif args.command == "upload":  # pragma: no cover - needs AWS
        uri = upload_data_to_s3(args.local_dir, args.bucket, args.prefix, args.include)
        print(f"Uploaded to: {uri}")
    elif args.command == "deploy":  # pragma: no cover - needs AWS
        ep = SageMakerEndpoint(args.endpoint_name)
        ep.deploy(
            args.model_data, args.role, args.image_uri,
            args.instance_type, args.instance_count, wait=not args.no_wait,
        )
        print(f"Endpoint deployed: {ep.endpoint_name}")
    elif args.command == "transform":  # pragma: no cover - needs AWS
        bt = SageMakerBatchTransform(
            args.model_data, args.role, args.image_uri,
            args.instance_type, args.instance_count,
        )
        out = bt.run(args.input_s3, args.output_s3, job_name=args.job_name)
        print(f"Transform output: {out}")
    else:
        parser.print_help()


if __name__ == "__main__":  # pragma: no cover
    main()
